"""The LM serving driver (:func:`repro_torch.launch.serve.serve`) edge
cases against the reference's (counterpart of
``tests/test_serve_driver.py``): ``gen=0`` returns ``[B, 0]`` and short
prompts (P == 1) decode greedily from the first step, through the same
deterministic stub model (predicts ``tok + 1 mod V``) on both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.serve import serve as jserve
from repro_torch.launch.serve import serve

V = 17


class _StubModel:
    """decode_step predicts (tok + 1) % V with probability one."""
    device = torch.device("cpu")

    def init_cache(self, B, L, dtype):
        return torch.zeros((B, 1), dtype=torch.int32)

    def decode_step(self, cache, tok, t):
        logits = torch.nn.functional.one_hot(
            (tok.long() + 1) % V, V).to(torch.float32)
        return logits, cache


class _JaxStubModel:
    def init_cache(self, B, L, dtype):
        return jnp.zeros((B, 1), jnp.int32)

    def decode_step(self, params, cache, tok, t):
        logits = jax.nn.one_hot((tok + 1) % V, V, dtype=jnp.float32)
        return logits, cache


def _expected(prompts, gen):
    """Greedy rollout of the stub: last prompt id + 1, +2, ... (mod V)."""
    last = np.asarray(prompts)[:, -1:]
    return (last + np.arange(1, gen + 1)) % V


@pytest.mark.parametrize("B,P", [(2, 4), (1, 1), (3, 1)])
def test_serve_gen_zero_returns_empty(B, P):
    prompts = np.arange(B * P, dtype=np.int32).reshape(B, P) % V
    out = serve(None, _StubModel(), torch.from_numpy(prompts), 0)
    want = jserve(None, _JaxStubModel(), None, jnp.asarray(prompts), 0)
    assert out.shape == (B, 0) == want.shape
    assert out.dtype == torch.int32 and want.dtype == jnp.int32


@pytest.mark.parametrize("P,gen", [(4, 3), (1, 1), (1, 5), (2, 1)])
def test_serve_short_prompts_greedy_decode(P, gen):
    B = 2
    prompts = (np.arange(B * P, dtype=np.int32).reshape(B, P) * 3 + 1) % V
    out = serve(None, _StubModel(), torch.from_numpy(prompts), gen)
    want = jserve(None, _JaxStubModel(), None, jnp.asarray(prompts), gen)
    assert out.shape == (B, gen) and out.dtype == torch.int32
    assert np.array_equal(out.numpy(), np.asarray(want))
    assert np.array_equal(out.numpy(), _expected(prompts, gen))
