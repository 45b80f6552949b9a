"""Device meshes (the counterpart of ``repro.launch.mesh``).

The production meshes keep the reference's shapes and axis names, so
every cell's sharding compares one to one with the reference's: (16, 16)
("data", "model"), and two of them stacked as (2, 16, 16) ("pod", "data",
"model"). A mesh is a ``torch.distributed`` ``DeviceMesh`` over an
initialised process group of that many ranks (the dry-run's is the
single-process "fake" backend). Functions, not module-level objects, so
importing this module touches no device or process group.

The per-device rates below are an NVIDIA H100 SXM's; the first three are
datasheet figures, not measurements.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.device import resolve_device

# NVIDIA H100 SXM datasheet figures (not measured)
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12               # B/s, HBM3
NVLINK_BW = 450e9              # B/s per direction, NVLink 4
# measured: a bf16 GEMM on an NVIDIA H100 80GB HBM3 at a 700 W limit
# (chip_smoke.py's pipeline phase)
MEASURED_GEMM_BF16 = 697e12    # FLOP/s

PRODUCTION_AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")


def production_shape(multi_pod: bool = False) -> dict[str, int]:
    """The production mesh's axis sizes by name (no process group)."""
    if multi_pod:
        return dict(zip(MULTI_POD_AXES, (2, 16, 16)))
    return dict(zip(PRODUCTION_AXES, (16, 16)))


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The (16, 16) or (2, 16, 16) mesh over the initialised process
    group, whose world size must be 256 or 512."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = production_shape(multi_pod)
    return init_device_mesh(device_type, tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def make_local_mesh(model_axis: int = 1, device_type=None):
    """A ("data", "model") mesh over every rank of the initialised process
    group, ``model_axis`` ranks on "model". On ``cuda`` unless
    ``device_type="cpu"`` is passed; raises without a GPU then."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"{n} ranks do not split into model axis "
                         f"{model_axis}")
    return init_device_mesh(dev.type, (n // model_axis, model_axis),
                            mesh_dim_names=PRODUCTION_AXES)
