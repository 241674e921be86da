"""The gradients of repro_torch's loss_fn against jax.value_and_grad, on
the CPU.

For every architecture at its ``reduced()`` size (f32), the JAX package's
weights are carried into the port and both differentiate ``loss_fn`` on
the same synthetic batch: the loss within 1e-5 and each gradient leaf
within 1e-5 of JAX's, relative to JAX's global gradient norm. Remat
(``"full"``, ``"dots"``) changes no gradient: equal to no remat bit for
bit, under the deterministic algorithms the trainer runs with.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 on, as in the reference's tests)
import repro.configs.registry as RR
import repro.data as RD
import repro.models as RM

import repro_torch.configs.registry as TR
import repro_torch.data as TD
import repro_torch.models as TM
from repro_torch import convert
from repro_torch.launch.train import deterministic

B, L = 2, 16


def port_grads(model, batch, cfg) -> tuple[float, dict]:
    model.zero_grad(set_to_none=True)
    with deterministic():
        total, metrics = TM.loss_fn(model, batch, cfg)
        total.backward()
    return float(metrics["loss"].detach()), {k: p.grad
                                    for k, p in model.named_parameters()}


@pytest.mark.parametrize("arch", RR.ARCHS)
def test_loss_fn_gradients_match_the_reference(arch):
    rcfg = RR.get_arch(arch).reduced()
    tcfg = TR.get_arch(arch).reduced()
    P = RM.init_params(rcfg, jax.random.key(0))
    rb = RD.SyntheticLM(rcfg, B, L, seed=3).batch_at(0)
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, b, rcfg), has_aux=True))(P, rb)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, P), tcfg,
                                         "cpu")
    tb = TD.SyntheticLM(tcfg, B, L, seed=3, device="cpu").batch_at(0)
    loss, got = port_grads(model, tb, tcfg)
    assert abs(loss - float(metrics["loss"])) <= 1e-5
    want = convert.lm_untree(jax.tree.map(np.asarray, grads), tcfg)
    assert set(got) == set(want)
    norm = float(np.sqrt(sum(np.sum(np.square(w.astype(np.float64)))
                             for w in want.values())))
    assert norm > 0
    for name, w in want.items():
        err = float(np.abs(got[name].numpy() - w).max())
        assert err <= 1e-5 * norm, (name, err, norm)


@pytest.mark.parametrize("arch", RR.ARCHS)
def test_remat_changes_no_gradient(arch):
    cfg = TR.get_arch(arch).reduced()
    batch = TD.SyntheticLM(cfg, B, L, seed=4, device="cpu").batch_at(0)
    grads = {}
    for policy in ("none", "full", "dots"):
        c = dataclasses.replace(cfg, remat=policy != "none",
                                remat_policy=policy)
        model = TM.init_params(c, torch.Generator().manual_seed(5), "cpu")
        grads[policy] = port_grads(model, batch, c)
    for policy in ("full", "dots"):
        assert grads[policy][0] == grads["none"][0]
        for name, g in grads["none"][1].items():
            assert torch.equal(grads[policy][1][name], g), (policy, name)


def test_unknown_remat_policy_is_refused():
    cfg = dataclasses.replace(TR.get_arch("llama3.2-1b").reduced(),
                              remat_policy="everything")
    model = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = TD.SyntheticLM(cfg, B, L, device="cpu").batch_at(0)
    with pytest.raises(ValueError, match="remat policy"):
        TM.loss_fn(model, batch, cfg)


@pytest.mark.parametrize("arch", RR.ARCHS)
def test_leaves_follow_the_reference_flatten_order(arch):
    """lm_stack's leaves and lm_order's names in jax.tree's order of the
    reference's stacked layout (the order the gradient norm sums and the
    compressed all-reduce numbers the leaves)."""
    rcfg = RR.get_arch(arch).reduced(scan_layers=True)
    tcfg = TR.get_arch(arch).reduced(scan_layers=True)
    P = RM.init_params(rcfg, jax.random.key(0))
    want = [".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(P)[0]]
    model = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    named = dict(model.named_parameters())
    stacked = convert.lm_stack(named, tcfg)
    assert list(stacked) == want
    # each reference leaf's layers, one after another, in its order
    assert convert.lm_order(list(named), tcfg) == [
        name for ref in want
        for name in convert.lm_unstack({ref: stacked[ref]}, tcfg)]
    assert convert.lm_unstack(stacked, tcfg).keys() == named.keys()
