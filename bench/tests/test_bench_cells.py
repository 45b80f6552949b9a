"""Each cell driven on the CPU at its smoke size, its chip look skipped:
the sound run is correct, and with the timed path broken underneath
``correct`` comes out false, once for each fault the cell can have."""
import pytest
import smoke

import torch

torch.set_num_threads(2)

# the smoke runs are fp32 against the fp32 reference: sound runs read 0 to
# rounding, so the limits here are tight
SERVE_LIMITS = {"served_gap_max": {"max": 1e-4},
                "served_tokens_checked": {"min": 10}}
CHAIN_LIMITS = {"hidden_rel_gap_max": {"max": 1e-4},
                "token_gap_max": {"max": 1e-4},
                "frames_checked": {"min": 1}}


def correct(cell, hook=None):
    run, rec, values, checks = smoke.run_cell(cell, hook)
    return rec["failed"] == 0 and all(c["ok"] for c in checks.values()), \
        values


def serve_cell(workload):
    cell = smoke.smoke_cell(workload)
    cell.limits = SERVE_LIMITS
    return cell


def wrap_step(run, after):
    """Break the engine's step: ``after(tokens, cache, saved)`` runs on
    every step's output, ``saved`` a copy of the cache from before it."""
    step = run.engine._step

    def broken(params, cache, tokens):
        saved = {k: v.clone() for k, v in cache.items()}
        nxt, cache = step(params, cache, tokens)
        after(nxt, cache, saved)
        return nxt, cache

    run.engine._step = broken


def token_altered(run):
    vocab = run.cell.dims["vocab"]

    def after(nxt, cache, saved):
        nxt[0] = (nxt[0] + 1) % vocab
    wrap_step(run, after)


def state_unchanged(run):
    """The step returns its cache as it found it (the position too)."""
    def after(nxt, cache, saved):
        for k, v in cache.items():
            v.copy_(saved[k])
    wrap_step(run, after)


def half_batch(run):
    """Half of the lanes left out: their tokens are the other half's."""
    def after(nxt, cache, saved):
        half = nxt.shape[0] // 2
        nxt[half:] = nxt[:half]
    wrap_step(run, after)


SERVE = ["phi3-14b.serve"]


@pytest.mark.parametrize("workload", SERVE)
def test_serve_sound_run_is_correct(workload):
    ok, values = correct(serve_cell(workload))
    assert ok, values


@pytest.mark.parametrize("workload", SERVE)
def test_serve_window_counts_its_own_requests(workload):
    """The lead-in's requests bring the engine to its load before the
    window opens: they are served, their tokens inside the window count,
    and only the window's requests are attempted, timed and checked."""
    cell = serve_cell(workload)
    run, rec, values, checks = smoke.run_cell(cell)
    due = [a.due_s for a in run.arrivals]
    assert rec["samples"]["lead_in_requests"] == sum(d < 0 for d in due) > 0
    assert rec["attempted"] == len(rec["ttft_ms"]) == sum(d >= 0 for d in due)
    assert all(r.done for r in run.reqs)
    assert all(run.arrivals[k].due_s >= 0 for k in run.sample())
    assert 0 < rec["tokens"] and 0 < rec["window_s"] < 1.5 * cell.seconds


@pytest.mark.parametrize("fault", [token_altered, state_unchanged,
                                   half_batch],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", SERVE)
def test_serve_fault_is_not_correct(workload, fault):
    ok, values = correct(serve_cell(workload), fault)
    assert not ok, values


def chain_cell():
    cell = smoke.smoke_cell("phi3-14b.chain")
    cell.limits = CHAIN_LIMITS
    return cell


def answer_altered(run, monkeypatch):
    from repro_torch.models import embedloss

    greedy = embedloss.greedy

    def altered(x, table, valid_vocab=None):
        return (greedy(x, table, valid_vocab) + 1) % valid_vocab
    monkeypatch.setattr(embedloss, "greedy", altered)


def layer_unchanged(run, monkeypatch):
    """The first layer's stage returns its input: a step that leaves its
    state as it found it."""
    from repro_torch.pipeline import stages

    layer = stages._layer
    first = run.params["layers"]["wq"][0].data_ptr()

    def skipped(model, lay, x, rope):
        if lay[1]["wq"].data_ptr() == first:
            return x
        return layer(model, lay, x, rope)
    monkeypatch.setattr(stages, "_layer", skipped)


def half_tokens(run, monkeypatch):
    """Half of each frame left out: the stages see its second half only."""
    from repro_torch.pipeline import stages

    embed_in = stages.embedloss.embed_in

    def halved(table, tokens, dtype):
        return embed_in(table, tokens[:, tokens.shape[1] // 2:], dtype)
    monkeypatch.setattr(stages.embedloss, "embed_in", halved)


def test_chain_sound_run_is_correct():
    ok, values = correct(chain_cell())
    assert ok, values


@pytest.mark.parametrize("fault", [answer_altered, layer_unchanged,
                                   half_tokens], ids=lambda f: f.__name__)
def test_chain_fault_is_not_correct(fault, monkeypatch):
    ok, values = correct(chain_cell(), lambda run: fault(run, monkeypatch))
    assert not ok, values
