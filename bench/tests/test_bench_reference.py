"""The plain reference against the program's smoke configurations on the
CPU (fp32): the same final hidden states and greedy tokens as
``Model.forward``; the fp8 control departs from both."""
import pytest
import smoke

import torch

from bench import weights
from bench.reference.model import Reference

torch.set_num_threads(2)


def test_reference_matches_program_forward():
    from repro_torch.models.transformer import STACK_DIMS, Model

    from bench.harness import port_config

    cell = smoke.smoke_cell("phi3-14b.chain")
    model = Model(port_config(cell))
    params = weights.make(model.param_shapes(), STACK_DIMS, 11, "cpu",
                          torch.float32)
    tokens = torch.randint(0, cell.dims["vocab"], (2, 37),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = model.forward(params, {"tokens": tokens.int()})
    ref = Reference(cell.dims, params)
    want = ref.hidden(tokens)
    rel = ((got - want).norm() / want.norm()).item()
    assert rel < 1e-5, rel
    logits = ref.logits(want)
    from repro_torch.models.embedloss import greedy
    prog = greedy(got.reshape(-1, got.shape[-1]), params["embed"],
                  valid_vocab=cell.dims["vocab"])
    assert (prog.long() == logits.reshape(-1, logits.shape[-1]).argmax(-1)
            ).float().mean() > 0.99
    low = Reference(cell.dims, params, fp8=True).hidden(tokens)
    assert ((low - want).norm() / want.norm()).item() > 100 * rel


def test_reference_runs_on_bf16_weights():
    """The weights the program serves are bf16; the reference upcasts each
    layer's as it runs and computes in fp32."""
    from repro_torch.models.transformer import STACK_DIMS, Model

    from bench.harness import port_config

    cell = smoke.smoke_cell("phi3-14b.chain", dtype="bfloat16")
    model = Model(port_config(cell))
    params = weights.make(model.param_shapes(), STACK_DIMS, 11, "cpu")
    assert params["layers"]["wq"].dtype == torch.bfloat16
    h = Reference(cell.dims, params).hidden(torch.zeros((1, 5),
                                                        dtype=torch.long))
    assert h.dtype == torch.float32 and torch.isfinite(h).all()
