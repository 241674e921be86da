"""The chunked, rematerialized scans of repro_torch against the JAX package's.

``repro_torch.models.ssm._selective_scan`` and ``rglru._rglru_scan`` cut
the time axis by the reference's chunk-count rule and checkpoint each
chunk while gradients are recorded. On numpy-seeded f32 inputs at small
widths they are held against ``repro.models.ssm._selective_scan`` and
``repro.models.rglru._rglru_scan`` (outputs, final state and the gradients
of a fixed scalar of both, within 1e-5), the port's chunked runs against
its one-chunk runs bit for bit under the three remat policies, and the
bytes a rematerialized forward keeps for backward against the chunk count.
The RG-LRU's chunk is its module's ``CHUNK`` in both packages; the tests
set it in both.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import repro.core  # noqa: F401  (x64 on, as in the reference's tests)
import repro.configs.registry as RR
from repro.models import rglru as RG
from repro.models import ssm as RS

import repro_torch.configs.registry as TR
from repro_torch import convert
from repro_torch.data import SyntheticLM
from repro_torch.launch.train import deterministic
from repro_torch.models import init_params, loss_fn
from repro_torch.models import rglru as TG
from repro_torch.models import ssm as TS

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
B, DI, S = 2, 16, 4


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


def scan_inputs(rng, L):
    """(u, Δ, B, C, A, D, h0) in f32: Δ small and positive, A positive."""
    f = np.float32
    return (rng.normal(size=(B, L, DI)).astype(f),
            (np.abs(rng.normal(size=(B, L, DI))) * 0.1).astype(f),
            rng.normal(size=(B, L, S)).astype(f),
            rng.normal(size=(B, L, S)).astype(f),
            (np.abs(rng.normal(size=(DI, S))) + 0.5).astype(f),
            rng.normal(size=(DI,)).astype(f),
            rng.normal(size=(B, DI, S)).astype(f))


def leaves(xs):
    return [torch.from_numpy(x).requires_grad_() for x in xs]


# ---- the chunk rule ---------------------------------------------------------

@pytest.mark.parametrize("L,chunk,n", [(1, 8, 1), (7, 8, 1), (8, 8, 1),
                                       (20, 8, 2), (21, 8, 1), (64, 8, 8),
                                       (2048, 128, 16), (24, 128, 1)])
def test_chunk_count_is_the_references(L, chunk, n):
    ref = max(1, L // chunk)
    while L % ref:
        ref -= 1
    assert TS.n_chunks_of(L, chunk) == ref == n


# ---- against the reference --------------------------------------------------

@pytest.mark.parametrize("L", [1, 7, 8, 20, 21, 64])
def test_selective_scan_and_its_gradients_match_the_reference(L):
    rng = np.random.default_rng(100 + L)
    xs = scan_inputs(rng, L)
    wy = rng.normal(size=(B, L, DI)).astype(np.float32)
    wh = rng.normal(size=(B, DI, S)).astype(np.float32)

    def ref(*a):
        y, h = RS._selective_scan(*a, chunk=8)
        return jnp.sum(y * wy) + jnp.sum(h * wh), (y, h)

    (_, (wy_out, wh_out)), wgrads = jax.jit(jax.value_and_grad(
        ref, argnums=tuple(range(7)), has_aux=True))(*map(jnp.asarray, xs))
    args = leaves(xs)
    y, h = TS._selective_scan(*args, chunk=8)
    close(y, wy_out)
    close(h, wh_out)
    ((y * torch.from_numpy(wy)).sum()
     + (h * torch.from_numpy(wh)).sum()).backward()
    for a, g in zip(args, wgrads):
        close(a.grad, g)


@pytest.fixture
def chunk8(monkeypatch):
    """Both packages' RG-LRU chunk set to 8."""
    monkeypatch.setattr(RG, "CHUNK", 8)
    monkeypatch.setattr(TG, "CHUNK", 8)


@pytest.mark.parametrize("L", [1, 7, 8, 20, 21, 64])
def test_rglru_scan_and_its_gradients_match_the_reference(L, chunk8):
    rcfg = RR.get_arch("recurrentgemma-2b").reduced(d_model=16,
                                                    rglru_width=16)
    tcfg = TR.get_arch("recurrentgemma-2b").reduced(d_model=16,
                                                    rglru_width=16)
    p = RG.init_rglru(jax.random.key(L), rcfg)
    port = TG.init_rglru(torch.Generator().manual_seed(0), tcfg)
    flat = convert._flatten(jax.tree.map(np.asarray, p))
    with torch.no_grad():
        for name, v in port.state_dict().items():
            v.copy_(torch.from_numpy(np.array(flat[name])))
    rng = np.random.default_rng(200 + L)
    W = tcfg.lru_width
    xs = rng.normal(size=(B, L, W)).astype(np.float32)
    h0 = rng.normal(size=(B, W)).astype(np.float32)
    wy = rng.normal(size=(B, L, W)).astype(np.float32)
    wh = rng.normal(size=(B, W)).astype(np.float32)

    def ref(p, xs, h0):
        y, h = RG._rglru_scan(p, xs, h0)
        return jnp.sum(y * wy) + jnp.sum(h * wh), (y, h)

    (_, (want_y, want_h)), (gp, gx, gh) = jax.jit(jax.value_and_grad(
        ref, argnums=(0, 1, 2), has_aux=True))(p, jnp.asarray(xs),
                                                jnp.asarray(h0))
    x_t, h_t = leaves((xs, h0))
    y, h = TG._rglru_scan(port, x_t, h_t)
    close(y, want_y)
    close(h, want_h)
    ((y * torch.from_numpy(wy)).sum()
     + (h * torch.from_numpy(wh)).sum()).backward()
    close(x_t.grad, gx)
    close(h_t.grad, gh)
    gflat = convert._flatten(jax.tree.map(np.asarray, gp))
    for name, prm in port.named_parameters():
        if name.split(".")[0] in ("gate_a", "gate_x", "lambda"):
            close(prm.grad, gflat[name])


# ---- the chunking changes no bit --------------------------------------------

def _loss_and_grads(arch, policy, ssm_chunk, L):
    cfg = TR.get_arch(arch).reduced(remat_policy=policy, ssm_chunk=ssm_chunk)
    model = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    batch = SyntheticLM(cfg, 2, L, seed=0, device=CPU).batch_at(0)
    with deterministic():
        loss, _ = loss_fn(model, batch, cfg)
        loss.backward()
    return loss.detach(), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("policy", ["full", "dots", "none"])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_chunked_equals_one_chunk_bit_for_bit(arch, policy, monkeypatch):
    """L 24: three chunks of 8 against one of 24, through loss_fn and its
    backward, the scan's checkpoints nested in the layer's remat."""
    monkeypatch.setattr(TG, "CHUNK", 8)
    loss8, g8 = _loss_and_grads(arch, policy, 8, 24)
    monkeypatch.setattr(TG, "CHUNK", 128)
    loss1, g1 = _loss_and_grads(arch, policy, 128, 24)
    assert torch.equal(loss8, loss1)
    assert g8.keys() == g1.keys()
    for k in g8:
        assert torch.equal(g8[k], g1[k]), k


def test_scans_record_no_graph_without_gradients():
    """Serving runs under no_grad: no checkpoint, and nothing kept."""
    xs = leaves(scan_inputs(np.random.default_rng(3), 20))
    with torch.no_grad():
        y, h = TS._selective_scan(*xs, chunk=8)
    assert y.grad_fn is None and h.grad_fn is None
    assert kept_bytes(lambda: TS._selective_scan(*xs, chunk=8),
                      xs, grad=False) == 0


# ---- what a rematerialized forward keeps ------------------------------------

class _Storages(TorchDispatchMode):
    """Weak references to the storage of every op's outputs."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.refs.append(weakref.ref(t.untyped_storage()))
        return out


def kept_bytes(fn, inputs, grad=True) -> int:
    """Bytes of the storages that `fn`'s ops made and that are still alive
    once it returns, less its outputs' and the inputs': what its autograd
    graph (and any checkpoint's frame) keeps for backward."""
    mode = _Storages()
    with torch.set_grad_enabled(grad), mode:
        out = fn()
    gc.collect()
    own = {t.untyped_storage().data_ptr() for t in (*tree_leaves(out),
                                                    *inputs)}
    alive = {}
    for ref in mode.refs:
        s = ref()
        if s is not None and s.data_ptr() not in own:
            alive[s.data_ptr()] = s.nbytes()
    del out
    return sum(alive.values())


def test_remat_keeps_bytes_by_chunk_count_not_length():
    state = B * DI * S * 4                  # one (B, DI, S) f32 state
    neg_a = DI * S * 4                      # −A, made once a scan

    def kept(L, chunk, remat=True):
        xs = leaves(scan_inputs(np.random.default_rng(L), L))
        return kept_bytes(lambda: TS._selective_scan(*xs, chunk=chunk,
                                                     remat=remat), xs)

    # the count sees the step-by-step loop's per-step tensors (without
    # remat, or in one chunk while backward recomputes it)
    plain16, plain32 = kept(16, 16, False), kept(32, 32, False)
    assert plain32 - plain16 >= 16 * 2 * state
    # remat'd: the state at each chunk boundary, whatever the length
    for L, chunk in [(16, 16), (64, 64), (16, 4), (32, 8), (64, 16),
                     (64, 32), (64, 4)]:
        n = TS.n_chunks_of(L, chunk)
        assert kept(L, chunk) == (n - 1) * state + neg_a, (L, chunk)
    assert kept(16, 4) == kept(64, 16)      # 4 chunks, 4× the length
    assert kept(64, 4) > kept(64, 16)       # 16 chunks against 4
