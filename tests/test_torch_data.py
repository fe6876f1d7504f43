"""The port's data pipeline (``repro_torch.data.pipeline``) against the
reference's (``repro.data.pipeline``).

The reference draws its synthetic tokens with ``jax.random`` (Threefry
2x32 in the partitionable counter layout of the installed JAX); the
port computes the same bits in numpy, so every batch must be bitwise
the reference's: over seeds, steps, shards, odd shapes and a memmapped
``token_file``.  Then ``test_substrate``'s pipeline cases re-run against
the port.
"""
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.data import pipeline as j_pipe
from repro_torch.data import pipeline as t_pipe
from repro_torch.data.pipeline import make_pipeline

# (vocab, seq, global batch, seed, shards, shard id): the integration
# tests' shapes, odd sizes, several shards, llama3.2-1b's vocabulary of
# 128256 at rows of 1025 tokens, a batch of one and the largest int32
# seed
PIPES = [(512, 64, 8, 0, 1, 0), (512, 32, 4, 0, 1, 0), (97, 33, 6, 3, 3, 2),
         (1000, 16, 8, 3, 2, 1), (128256, 1024, 4, 0, 1, 0),
         (2, 1, 1, 11, 1, 0), (257, 8, 2, 2 ** 31 - 1, 1, 0)]
STEPS = (0, 1, 17, 4096, 2 ** 31 - 1)


def _equal(got, want):
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("pipe", PIPES, ids=lambda p: "_".join(map(str, p)))
def test_batches_are_bitwise_the_references(pipe):
    v, s, b, seed, shards, sid = pipe
    kw = dict(seed=seed, n_shards=shards, shard_id=sid)
    want, got = j_pipe.make_pipeline(v, s, b, **kw), make_pipeline(v, s, b,
                                                                   **kw)
    for step in STEPS[:3] if v > 100_000 else STEPS:
        _equal(got[step], want[step])


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2 ** 31 - 1, 2 ** 32 - 1])
def test_threefry_keys_and_uniforms_are_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(key), t_pipe.prng_key(seed))
    for data in (0, 3, 2 ** 31 - 1, 2 ** 32 - 1):
        jk = jax.random.fold_in(key, data)
        tk = t_pipe.fold_in(t_pipe.prng_key(seed), data)
        np.testing.assert_array_equal(np.asarray(jk), tk)
        for shape in ((1,), (3, 17), (2, 3, 5)):
            u = np.asarray(jax.random.uniform(jk, shape))
            np.testing.assert_array_equal(
                u.view(np.uint32), t_pipe.uniform(tk, shape).view(np.uint32))
            np.testing.assert_array_equal(
                np.asarray(jax.random.bits(jk, shape)),
                t_pipe.random_bits(tk, shape))


def test_token_file_batches_are_the_references(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 50_000, 10_007).astype(
        np.int32).tofile(path)
    for shards, sid in ((1, 0), (2, 1)):
        kw = dict(seed=5, n_shards=shards, shard_id=sid,
                  token_file=str(path))
        want = j_pipe.make_pipeline(50_000, 31, 6, **kw)
        got = make_pipeline(50_000, 31, 6, **kw)
        for step in (0, 1, 9, 1000):
            _equal(got[step], want[step])


def test_iter_from_resumes_at_the_step():
    p = make_pipeline(1000, 16, 4, seed=7)
    it = p.iter_from(40)
    for step in (40, 41, 42):
        b = next(it)
        assert torch.equal(b["tokens"], p[step]["tokens"])


# --------------------------------------------------------------------------
# test_substrate's pipeline cases, on the port
# --------------------------------------------------------------------------
def test_pipeline_deterministic_and_seekable():
    p1 = make_pipeline(1000, 16, 4, seed=7)
    p2 = make_pipeline(1000, 16, 4, seed=7)
    b_51a = p1[51]
    _ = p1[0], p1[99]
    b_51b = p1[51]
    assert torch.equal(b_51a["tokens"], b_51b["tokens"])
    assert torch.equal(b_51a["tokens"], p2[51]["tokens"])


def test_pipeline_shards_disjoint():
    a = make_pipeline(1000, 16, 8, seed=3, n_shards=2, shard_id=0)[5]
    b = make_pipeline(1000, 16, 8, seed=3, n_shards=2, shard_id=1)[5]
    assert tuple(a["tokens"].shape) == (4, 16)
    assert not torch.equal(a["tokens"], b["tokens"])


def test_pipeline_labels_are_shifted_tokens():
    b = make_pipeline(1000, 16, 2, seed=0)[0]
    assert b["tokens"].shape == b["labels"].shape
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 1000), step=st.integers(0, 10_000))
def test_pipeline_vocab_range(seed, step):
    toks = make_pipeline(257, 8, 2, seed=seed)[step]["tokens"]
    assert int(toks.min()) >= 0 and int(toks.max()) < 257
