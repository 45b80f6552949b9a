"""Public wrapper of the SSD scan kernel, the port's counterpart of
``repro.kernels.ssd_scan.ops``. The reference's ``interpret`` flag has no
counterpart: CPU tensors run the plain version, CUDA tensors the kernel."""
from __future__ import annotations

from repro_torch.kernels.ssd_scan.kernel import ssd_cuda


def ssd(x, dt, a, bmat, cmat, *, chunk=128):
    """(y (B, L, H, P), final state (B, H, P, N) fp32) from zero state; the
    arguments as :func:`~repro_torch.kernels.ssd_scan.kernel.ssd_cuda`."""
    return ssd_cuda(x, dt, a, bmat, cmat, chunk=chunk)
