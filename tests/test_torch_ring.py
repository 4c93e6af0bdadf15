"""Ring attention (``parallel/context.py``) on 2 gloo ranks against the
JAX package's ``ring_attention_sharded``, on the CPU; 4 ranks in
tests/test_torch_ring4.py, which shares this file's helpers (split so
that pytest's ``--dist loadfile`` runs the two worlds on two workers).

Each world is spawned once (``launchers.debug_launcher``, a module-scoped
fixture) and runs every case: causal and not, GQA (H 4
over KVH 2), a chunk of 128 positions a rank, D 128, fp32. The rank
workers' hops take the kernels' plain versions (CPU tensors); the
reference runs its Pallas flash kernels in interpret mode over a
``sequence`` mesh of the 8 host devices, forward and backward in one
jitted program. Tolerances: outputs 1e-5, dq /
dk / dv 1e-4, absolute (fp32; the hops' softmax and the merge sum in
another order). The lockstep composition ``chip_smoke.py`` runs on one
card (``ring_lockstep``) gives the ring's tensors bit for bit.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu.parallel.context import ring_attention_sharded as ref_ring
from accelerate_tpu.parallel.mesh import build_mesh as ref_mesh
from accelerate_tpu_torch.launchers import debug_launcher
from accelerate_tpu_torch.parallel.context import ring_lockstep
from torch_dist_workers import gathered, ring_worker

B, H, KVH, CHUNK, D = 2, 4, 2, 128, 128
WORLD_TIMEOUT = 240


def _case(seed, n, causal):
    rng = np.random.RandomState(seed)
    s = n * CHUNK
    return {"q": rng.randn(B, H, s, D).astype(np.float32),
            "k": rng.randn(B, KVH, s, D).astype(np.float32),
            "v": rng.randn(B, KVH, s, D).astype(np.float32),
            "do": rng.randn(B, H, s, D).astype(np.float32), "causal": causal}


def spawn_world(n, tmp_path_factory):
    """The n-rank world's chunks of every case (causal and not)."""
    import pickle

    d = tmp_path_factory.mktemp(f"ring{n}")
    cases = {causal: _case(10 * n + causal, n, causal) for causal in (True, False)}
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump({"cases": cases}, f)
    debug_launcher(ring_worker, (str(d),), num_processes=n, timeout=WORLD_TIMEOUT)
    return n, cases, gathered(str(d), "ring", n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(2, tmp_path_factory)


def _reference(case, n):
    """The reference's ring on a {sequence: n} mesh of the 8 host devices
    (the rest on ``data``), its flash kernels interpreted: out and the
    gradients of sum(out * do)."""
    mesh = ref_mesh({"replica": 1, "stage": 1, "data": 8 // n, "fsdp": 1, "expert": 1,
                     "sequence": n, "tensor": 1})
    q, k, v, do = (jnp.asarray(case[x]) for x in ("q", "k", "v", "do"))

    def f(q, k, v):
        return ref_ring(q, k, v, mesh, causal=case["causal"], impl="flash", interpret=True)

    def out_and_grads(q, k, v, do):
        out, vjp = jax.vjp(f, q, k, v)
        return (out, *vjp(do))

    # one jitted program: the same values as the eager calls, in half the time
    return tuple(np.asarray(t) for t in jax.jit(out_and_grads)(q, k, v, do))


def _whole(ranks, key, causal, name):
    return np.concatenate([r[causal][name].numpy() for r in ranks], axis=2)


def check_reference(world, causal):
    n, cases, ranks = world
    want = _reference(cases[causal], n)
    for name, w, tol in zip(("out", "dq", "dk", "dv"), want, (1e-5, 1e-4, 1e-4, 1e-4)):
        np.testing.assert_allclose(_whole(ranks, None, causal, name), w, atol=tol, rtol=0,
                                   err_msg=f"{name} (n {n}, causal {causal})")


def check_lockstep(world, causal):
    n, cases, ranks = world
    case = cases[causal]
    chunks = {x: [torch.from_numpy(c.copy()) for c in np.split(case[x], n, axis=2)]
              for x in ("q", "k", "v", "do")}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' own (debug_launcher's default)
    try:
        outs, (dqs, dks, dvs) = ring_lockstep(chunks["q"], chunks["k"], chunks["v"],
                                              chunks["do"], causal=causal, impl="flash")
    finally:
        torch.set_num_threads(threads)
    for r in range(n):
        for name, got in (("out", outs[r]), ("dq", dqs[r]), ("dk", dks[r]), ("dv", dvs[r])):
            assert torch.equal(got, ranks[r][causal][name]), (name, r)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_matches_reference(world, causal):
    check_reference(world, causal)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_lockstep_is_the_ring_bit_for_bit(world, causal):
    check_lockstep(world, causal)


def test_trivial_axis_is_plain_attention():
    """n == 1: the reference's fallback, dot_product_attention."""
    from accelerate_tpu_torch.ops.attention import mha_reference
    from accelerate_tpu_torch.parallel.context import ring_attention_sharded

    case = _case(0, 1, True)
    q, k, v = (torch.from_numpy(case[x]) for x in ("q", "k", "v"))
    got = ring_attention_sharded(q, k, v, None, causal=True)
    assert torch.equal(got, mha_reference(q, k, v, causal=True))
