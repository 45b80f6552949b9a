"""Build the port's CUDA kernels from the sources in the checkout.

The kernels (``*/csrc/*.cu``: flash attention, chunked two-pass attention,
the SSD scan and its decode update, the sequence forward's pointwise ops)
are compiled by ``nvcc`` for ``sm_90a`` and bound to Python by
``torch.utils.cpp_extension.load`` as one extension, with one small
binding file (``csrc/binding.cpp``), the only source that includes
PyTorch's headers; ninja compiles the sources in parallel. The build
runs at first use, into ``build/kernels`` at the root of the checkout
(listed in ``.gitignore``), and is cached there by content. A failed
build raises; nothing falls back to the plain versions.

It is also the seam every wrapper shares: which device a call runs on
(:func:`all_cpu`, :func:`check_cuda`), whether the model routes a call to
a kernel (:func:`route`), and the one count of launches (``launches``).
"""
from __future__ import annotations

from collections import Counter
from pathlib import Path

from repro_torch.kernels.autograd import needs_grad
from repro_torch.sharding import rules

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parents[2] / "build" / "kernels"
SOURCES = (HERE / "csrc" / "binding.cpp",
           HERE / "flash_attention" / "csrc" / "flash_attention.cu",
           HERE / "flash_attention" / "csrc" / "chunked_attention.cu",
           HERE / "ssd_scan" / "csrc" / "ssd_scan.cu",
           HERE / "ssd_scan" / "csrc" / "ssd_decode.cu",
           HERE / "pointwise" / "csrc" / "pointwise.cu")
CUDA_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-Xptxas=-v")


_extension = None

# launches by kernel: +1 for each wrapper call that launched, however
# many CUDA kernels it runs; nothing on the CPU path, on a raise or in a
# backward. Keys: flash_attention, chunked_attention, ssd_scan, ssd_decode,
# rms_norm, add_rms_norm, rope_qk, swiglu_gate. A reader clears it and
# reads it by key.
launches: Counter[str] = Counter()


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


def all_cpu(*tensors) -> bool:
    """Whether a kernel wrapper was given CPU tensors only: it then runs
    its kernel's plain version."""
    return all(t.device.type == "cpu" for t in tensors)


def check_cuda(name, *tensors):
    """Tensors a kernel wrapper was given that are not all on the CPU must
    all be CUDA tensors: the wrapper then launches its kernel."""
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(
            f"{name} takes CPU tensors (plain version) or CUDA tensors "
            f"(kernel), got {', '.join(str(t.device) for t in tensors)}")


def route(takes, *args, params=()) -> bool:
    """Whether the model hands a call to a kernel, decided from what it is
    given: no DTensor among ``args`` and ``params`` (an extension takes
    none, and ``takes`` is not written for them), then the kernel's own
    ``takes(*args)``, then autograd records none of them (training keeps
    the plain ops and their gradients). The CPU, the mesh, training and
    what a kernel does not take keep the plain ops."""
    given = (*args, *params)
    return not any(rules.is_dtensor(t) for t in given) and takes(*args) \
        and not needs_grad(*given)
