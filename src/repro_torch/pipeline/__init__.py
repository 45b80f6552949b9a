"""The paper's executor, the port's counterpart of ``repro.pipeline``: the
planner (:mod:`~repro_torch.pipeline.planner`), the streaming runtime
(:mod:`~repro_torch.pipeline.runtime`) and its shared-memory frame rings
(:mod:`~repro_torch.pipeline.shm`)."""
from .planner import (  # noqa: F401
    H100_CLASS,
    DeviceClass,
    HeterogeneousSystem,
    PipelinePlan,
    model_chain,
    plan_pipeline,
)
from .runtime import StreamingPipelineRuntime, StageSpec  # noqa: F401
