"""PyTorch/CUDA port of litehandnet_tpu for NVIDIA Hopper (H100).

The port mirrors the JAX package's tree (``config``, ``models``, ``ops``,
``losses``, ``data``, ``train``, ``eval``, ``tools``) so that each file
names the reference file it replaces. Hand-written
Hopper kernels live in ``kernels/`` with their CUDA C++ sources in ``csrc/``;
each is built with ``nvcc`` at first use. Public functions keep the JAX
package's layouts: ``[B, H, W, 3]`` uint8 images in, ``[B, H, W, K]`` heatmaps
into decode. Modules run NCHW (in ``channels_last`` memory) inside.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no CUDA device they raise instead of falling back to the CPU.

Importing the package imports no torch: the decode worker processes
(``data/mp_decode.py``) import it and stay off torch and CUDA.
"""


def resolve_device(device="cuda") -> "torch.device":
    """The device an entry point runs on.

    Raises:
        RuntimeError: ``device`` is a CUDA device and CUDA is unavailable.
    """
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
