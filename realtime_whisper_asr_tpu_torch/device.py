"""Device policy of the port's entry points: the card unless asked otherwise."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing a CUDA device on a host without
    CUDA: the port never falls back to the CPU on its own. Pass
    ``device="cpu"`` to run there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this host; pass device='cpu' "
                           "to run the port on the CPU")
    return dev


@contextlib.contextmanager
def no_tf32_cudnn():
    """cuDNN runs f32 convolutions and LSTMs in TF32 unless told otherwise
    (PyTorch's default); inside this block they keep IEEE f32, so an f32
    module computes the function the parity checks hold against the JAX
    package, whatever the process-wide setting. cuBLAS f32 matmuls are IEEE
    by PyTorch's default."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@contextlib.contextmanager
def no_tf32_matmul():
    """cuBLAS f32 matmuls in IEEE f32 inside this block, whatever the
    process-wide ``torch.backends.cuda.matmul.allow_tf32`` says."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@contextlib.contextmanager
def exact_kernels():
    """IEEE f32 cuBLAS matmuls and cuDNN convolutions and RNNs, and
    deterministic cuDNN algorithms, inside this block: the training steps
    run their forward AND backward in it (a backward op reads the flags when
    it runs, after a forward block has closed), so an f32 step computes the
    JAX package's function and a resumed run repeats an uninterrupted one
    bit for bit."""
    with no_tf32_matmul(), no_tf32_cudnn():
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            yield
        finally:
            torch.backends.cudnn.deterministic = prev
