import torch

GEN = torch.Generator().manual_seed(0)


def table(n):
    return torch.zeros(n, dtype=torch.float64, generator=None)


def main():
    torch.manual_seed(0)


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    main()
