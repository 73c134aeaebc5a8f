"""Port parity for token sampling (temperature, top-k, top-p).

The keep-masks must equal the JAX package's exactly: the JAX functions'
filtered logits are captured where they reach ``jax.random.categorical``.
The draws themselves cannot match (torch.Generator vs jax.random bits), so
the port's sampled frequencies are held to the distribution JAX samples
from: 8000 seeded draws, each frequency within 0.025 of its probability
(about five standard deviations of the largest).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.models import sampling as jsampling
from elastic_gpu_scheduler_tpu_torch.models import sampling

# the suite runs in parallel worker processes: one intra-op thread keeps
# this file from crowding the workers that run beside it
torch.set_num_threads(1)


def _capture(monkeypatch):
    seen = []
    real = jax.random.categorical

    def spy(key, logits, axis=-1, **kw):
        seen.append(np.asarray(logits))
        return real(key, logits, axis=axis, **kw)

    monkeypatch.setattr(jax.random, "categorical", spy)
    return seen


def _logits(B=5, V=40, seed=0):
    return np.random.default_rng(seed).standard_normal((B, V)).astype(np.float32) * 2


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.7), (8, 0.5), (3, 0.0)])
def test_static_keep_mask_matches_jax(monkeypatch, top_k, top_p):
    lg = _logits()
    seen = _capture(monkeypatch)
    jsampling.sample_static(jnp.asarray(lg), jax.random.key(0), 0.8, top_k, top_p)
    got = sampling.filter_static(torch.from_numpy(lg), 0.8, top_k, top_p)
    np.testing.assert_array_equal(np.isfinite(got.numpy()), np.isfinite(seen[-1]))


def test_batched_keep_mask_matches_jax(monkeypatch):
    lg = _logits(B=6)
    temps = np.array([0.0, 0.5, 1.0, 1.3, 0.9, 2.0], np.float32)
    top_ks = np.array([0, 3, 0, 10, 1, 5], np.int32)
    top_ps = np.array([1.0, 1.0, 0.6, 0.8, 0.3, 0.0], np.float32)
    seen = _capture(monkeypatch)
    jsampling.sample_batched(
        jnp.asarray(lg), jax.random.key(0), jnp.asarray(temps),
        jnp.asarray(top_ks), jnp.asarray(top_ps),
    )
    got = sampling.filter_batched(
        torch.from_numpy(lg), torch.from_numpy(temps), torch.from_numpy(top_ks),
        torch.from_numpy(top_ps),
    )
    np.testing.assert_array_equal(np.isfinite(got.numpy()), np.isfinite(seen[-1]))
    np.testing.assert_allclose(
        np.where(np.isfinite(seen[-1]), got.numpy(), 0),
        np.where(np.isfinite(seen[-1]), seen[-1], 0), rtol=1e-6,
    )


def test_greedy_rows_and_frequencies_match_distribution(monkeypatch):
    V, N = 6, 8000
    row = np.array([1.0, 0.5, 0.2, -0.3, 2.0, -1.0], np.float32)
    temps = np.array([0.7, 0.0], np.float32)
    top_ks = np.array([4, 0], np.int32)
    top_ps = np.array([0.9, 1.0], np.float32)
    lg = np.stack([row, row])
    seen = _capture(monkeypatch)
    jsampling.sample_batched(
        jnp.asarray(lg), jax.random.key(0), jnp.asarray(temps),
        jnp.asarray(top_ks), jnp.asarray(top_ps),
    )
    masked = seen[-1][0]
    probs = np.exp(masked - masked[np.isfinite(masked)].max())
    probs = np.where(np.isfinite(masked), probs, 0.0)
    probs /= probs.sum()

    gen = torch.Generator().manual_seed(1234)
    lgt = torch.from_numpy(np.repeat(lg, N // 2, axis=0))
    draws = sampling.sample_batched(
        lgt, gen, torch.from_numpy(np.tile(temps, N // 2)),
        torch.from_numpy(np.tile(top_ks, N // 2)), torch.from_numpy(np.tile(top_ps, N // 2)),
    ).numpy()
    sampled, greedy = draws[0::2], draws[1::2]
    assert (greedy == int(np.argmax(row))).all()
    freq = np.bincount(sampled, minlength=V) / len(sampled)
    assert (freq[probs == 0] == 0).all()  # filtered tokens are never drawn
    np.testing.assert_allclose(freq, probs, atol=0.025)


def test_sample_static_greedy_and_top1_survives():
    lg = torch.from_numpy(_logits())
    g = torch.Generator().manual_seed(0)
    assert torch.equal(sampling.sample_static(lg, g), torch.argmax(lg, -1))
    # top_p 0 keeps exactly the top-1 token: sampling becomes argmax
    assert torch.equal(sampling.sample_static(lg, g, 1.0, 0, 0.0), torch.argmax(lg, -1))
