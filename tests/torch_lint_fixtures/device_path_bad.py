import numpy as np
import torch


class CodecBatcher:
    def encode(self, codec, batch):
        out = codec.encode_batch(torch.from_numpy(batch).cuda())
        return _fan_out(out)


def _fan_out(out: torch.Tensor):
    torch.cuda.synchronize()            # waits for the card per batch
    first = out[0].item()               # a sync per batch
    rows = np.asarray(out)              # a tensor pulled to the host
    return first, rows, out.cpu()       # and the batch copied back
