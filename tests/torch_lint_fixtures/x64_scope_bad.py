import torch
from torch import backends

torch.set_default_dtype(torch.float64)
torch.manual_seed(0)
backends.cuda.matmul.allow_tf32 = True


class Codec:
    torch.use_deterministic_algorithms(True)
