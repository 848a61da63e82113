import torch


class MeshCodec:
    def rmw(self, codec, old_parity, delta, out_np=True):
        old = old_parity.to("cuda")
        old.bitwise_xor_(delta)
        return old


def update(mesh, codec, old: torch.Tensor, delta):
    new = mesh.rmw(codec, old, delta, out_np=False)
    return new, old.sum()          # old IS new now: read after the launch
