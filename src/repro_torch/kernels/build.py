"""Build the port's CUDA kernels from the sources in the checkout.

The kernels (``*/csrc/*.cu``) are compiled by ``nvcc`` for ``sm_90a`` and
bound to Python by ``torch.utils.cpp_extension.load`` with one small
binding file, the only source that includes PyTorch's headers. The build
runs at first use, into ``build/kernels`` at the root of the checkout
(listed in ``.gitignore``), and is cached there by content. A failed
build raises; nothing falls back to the plain versions.
"""
from __future__ import annotations

from pathlib import Path

CSRC = Path(__file__).resolve().parent / "flash_attention" / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = (CSRC / "binding.cpp", CSRC / "flash_attention.cu")
CUDA_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-Xptxas=-v")


_extension = None


def extension(verbose: bool = False):
    """The compiled extension module, built on the first call of the
    process. With ``verbose`` that build prints the compiler's output,
    ``ptxas`` registers, spills and shared memory included."""
    global _extension
    if _extension is None:
        import torch
        from torch.utils import cpp_extension

        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA kernels need a CUDA device")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _extension = cpp_extension.load(
            name="repro_torch_kernels", sources=[str(s) for s in SOURCES],
            build_directory=str(BUILD_DIR), extra_cflags=["-O2"],
            extra_cuda_cflags=list(CUDA_FLAGS), verbose=verbose)
    return _extension
