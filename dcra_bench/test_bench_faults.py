"""A whole run of each cell, with the port broken underneath, must come
out not correct: a round or step that leaves its state unchanged, half
of the work left out, the exchange between shards left out, and an
answer altered where the port produces it. The look for a card is
skipped; the rest of the run is the benchmark's own."""
import dataclasses

import pytest
import torch

from dcra_bench import harness

GRAPH_CELLS = ("kron23-bfs", "kron23-pagerank")


def run_tiny(tiny_cell, name, seed=2 ** 31 + 101):
    spec, cell, cfg, tr = tiny_cell(name)
    return harness.run_cell(spec, cell, seed, 0.2, False, "cpu", 0.0, cfg,
                            tr)


@pytest.mark.parametrize("name", GRAPH_CELLS + ("olmoe-moe-fwd",))
def test_sound_run_is_correct(tiny_cell, name):
    assert run_tiny(tiny_cell, name).correct


# ---------------------------------------------------------------------------
# the graph cells
# ---------------------------------------------------------------------------

def _unchanged_update(ctx, state, frontier, upd):
    return tuple(state), torch.zeros_like(frontier)


def break_state(monkeypatch):
    """Every round returns its state unchanged."""
    from repro_torch.sparse import program, torch_apps
    for name in ("bfs", "pagerank"):
        monkeypatch.setitem(torch_apps.PROGRAMS, name, dataclasses.replace(
            torch_apps.PROGRAMS[name], update=_unchanged_update))
    program.clear_cache()


def break_half(monkeypatch):
    """Half of each round's tasks left out (every other edge slot)."""
    from repro_torch.core import routing
    from repro_torch.sparse import program
    real = routing.owner_route

    def half(vals, slot_ids, owner, valid, *a, **k):
        keep = torch.zeros_like(valid)
        keep[:, ::2] = True
        return real(vals, slot_ids, owner, valid & keep, *a, **k)
    monkeypatch.setattr(program, "owner_route", half)
    program.clear_cache()


def break_exchange(monkeypatch):
    """The all_to_all between shards left out: each shard keeps what it
    would have sent."""
    from repro_torch.core import dispatch, routing
    from repro_torch.sparse import program
    ident = lambda x, shape, dim, exchange=None: x  # noqa: E731
    monkeypatch.setattr(routing, "noc_all_to_all", ident)
    monkeypatch.setattr(dispatch, "noc_all_to_all", ident)
    program.clear_cache()


def break_answer(monkeypatch):
    """One vertex's answer altered as the launch hands it back."""
    from repro_torch.sparse import program
    real = program.ProgramLaunch.result

    def altered(self):
        states, stats = real(self)
        s0 = states[0].copy()
        s0[int(s0.argmin())] += 1.0
        return (s0, *states[1:]), stats
    monkeypatch.setattr(program.ProgramLaunch, "result", altered)


GRAPH_FAULTS = {"state_unchanged": break_state, "half_left_out": break_half,
                "exchange_left_out": break_exchange,
                "answer_altered": break_answer}


@pytest.mark.parametrize("fault", sorted(GRAPH_FAULTS))
@pytest.mark.parametrize("name", GRAPH_CELLS)
def test_graph_fault_is_caught(tiny_cell, monkeypatch, name, fault):
    GRAPH_FAULTS[fault](monkeypatch)
    try:
        run = run_tiny(tiny_cell, name)
    finally:
        from repro_torch.sparse import program
        program.clear_cache()
    assert not run.correct
    assert run.failed > 0


# ---------------------------------------------------------------------------
# the MoE cell
# ---------------------------------------------------------------------------

def _wrap_moe(monkeypatch, after=None, before=None):
    from repro_torch.core import dispatch
    real = dispatch.moe_dcra

    def broken(params, x, *a, **k):
        if before is not None:
            x = before(x)
        res = real(params, x, *a, **k)
        return (after(res[0], x), *res[1:]) if after else res
    monkeypatch.setattr(dispatch, "moe_dcra", broken)


def moe_state(monkeypatch):
    """The step hands back its input: the layer's state unchanged."""
    _wrap_moe(monkeypatch, after=lambda out, x: x.clone())


def moe_half(monkeypatch):
    """Half of the batch left out: the other half's mean in its place."""
    def half(out, x):
        b = out.shape[0] // 2
        out = out.clone()
        out[b:] = out[:b].mean(0, keepdim=True)
        return out
    _wrap_moe(monkeypatch, after=half)


def moe_token(monkeypatch):
    """One token's output altered as the layer produces it."""
    def one(out, x):
        out = out.clone()
        out[0, 0] = -out[0, 0]
        return out
    _wrap_moe(monkeypatch, after=one)


MOE_FAULTS = {"state_unchanged": moe_state, "half_left_out": moe_half,
              "exchange_left_out": break_exchange,
              "answer_altered": moe_token}


@pytest.mark.parametrize("fault", sorted(MOE_FAULTS))
def test_moe_fault_is_caught(tiny_cell, monkeypatch, fault):
    MOE_FAULTS[fault](monkeypatch)
    run = run_tiny(tiny_cell, "olmoe-moe-fwd")
    assert not run.correct
    assert run.failed > 0
