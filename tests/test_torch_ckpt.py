"""repro_torch.ckpt against the JAX package's checkpoint format, on the CPU.

A checkpoint is interchangeable both ways: the JAX ``CheckpointManager``'s
save of a reduced llama's params and AdamW state (bf16 leaves among them;
the list layout and the stacked one) and the port's Trainer's save of the
same state have identical manifests (keys, files, shapes, dtype names,
sha1s) and identical files, byte for byte; each restores in the other
package to the same values exactly. Also the reference's atomicity,
keep-k and reshard cases (tests/test_fault_tolerance.py) on the port, and
the rule that the port never imports ml_dtypes.
"""

import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 on, as in the reference's tests)
import repro.ckpt as RCK
import repro.configs.registry as RR
import repro.models as RM
import repro.optim as RO

import repro_torch.configs.registry as TR
from repro_torch import convert
from repro_torch.ckpt import CheckpointManager
from repro_torch.launch.train import TrainConfig, Trainer

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_checkpoint_atomicity_and_gc(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    tree = {"a": torch.arange(8, dtype=torch.float32),
            "b": {"c": torch.full((3, 3), 1.5, dtype=torch.bfloat16)}}
    for s in (1, 2, 3, 4):
        m.save(s, tree, block=True)
    assert m.all_steps() == [3, 4]          # keep-2 GC
    assert m.latest_step() == 4
    out = m.restore(4, tree)
    assert torch.equal(out["a"], tree["a"])
    assert out["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    # no stray .tmp directories (atomicity)
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_async_save_snapshots_before_the_tensors_change(tmp_path):
    m = CheckpointManager(str(tmp_path))
    w = torch.arange(1 << 16, dtype=torch.float32)
    m.save(1, {"w": w})
    w.zero_()                               # the next step's in-place update
    m.wait()
    assert torch.equal(m.restore(1, {"w": w})["w"],
                       torch.arange(1 << 16, dtype=torch.float32))


def test_restore_refuses_a_shape_mismatch(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=False)
    m.save(1, {"w": torch.zeros(4, 4)})
    with pytest.raises(ValueError, match="shape mismatch at w"):
        m.restore(1, {"w": torch.zeros(4, 5)})


def test_elastic_reshard_restore(tmp_path):
    """Restore under another placement: full leaves + sharding_fn (here
    data rank 1 of 2 takes its row block)."""
    m = CheckpointManager(str(tmp_path), async_save=False)
    tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4),
            "s": torch.tensor(3, dtype=torch.int32)}
    m.save(1, tree, block=True)
    seen = {}

    def shard(key, host):
        seen[key] = (host.device.type, host.dtype)
        return host[2:4].clone() if key == "w" else host

    out = m.restore(1, tree, sharding_fn=shard)
    assert torch.equal(out["w"], tree["w"][2:4])
    assert int(out["s"]) == 3
    assert seen == {"s": ("cpu", torch.int32), "w": ("cpu", torch.float32)}


def test_the_port_never_imports_ml_dtypes():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    offenders = [str(f) for f in files
                 if "import ml_dtypes" in f.read_text()]
    assert not offenders, offenders


# ---- interchange with the JAX package ---------------------------------------

LAYOUTS = {"layers_list": {}, "layers": {"scan_layers": True}}
KW = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
          d_ff=128, vocab_size=256, param_dtype="bfloat16")
STEP = 7


def reference_state(layout):
    """The reference's {"params", "opt"} of a reduced llama (bf16
    parameters, f32 moments drawn from a seed), as JAX arrays."""
    rcfg = RR.get_arch("llama3.2-1b").reduced(**KW, **LAYOUTS[layout])
    params = RM.init_params(rcfg, jax.random.key(1))
    rng = np.random.default_rng(2)

    def drawn(p):
        return jnp.asarray(rng.normal(size=p.shape).astype(np.float32))

    opt = RO.OptState(step=jnp.asarray(STEP, jnp.int32),
                      mu=jax.tree.map(drawn, params),
                      nu=jax.tree.map(lambda p: drawn(p) ** 2, params))
    return {"params": params, "opt": opt}


def port_trainer(layout, ckpt_dir):
    cfg = TR.get_arch("llama3.2-1b").reduced(**KW, **LAYOUTS[layout])
    return cfg, Trainer(cfg, TrainConfig(batch=2, seq_len=8), ckpt_dir=ckpt_dir,
                        device="cpu")


def manifest(path) -> dict:
    with open(os.path.join(path, f"step_{STEP:08d}", "manifest.json")) as f:
        m = json.load(f)
    return {"step": m["step"], "leaves": m["leaves"],
            "order": list(m["leaves"])}


def assert_equal_trees(got, want):
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, a), (_, b) in zip(gl, wl):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), jax.tree_util.keystr(path)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_checkpoints_are_interchangeable_with_the_reference(tmp_path,
                                                            layout):
    want = reference_state(layout)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    RCK.CheckpointManager(jdir, async_save=False).save(STEP, want,
                                                       block=True)

    # the port's Trainer holding the same state saves it
    cfg, tr = port_trainer(layout, tdir)
    np_want = jax.tree.map(np.asarray, want)
    tr.params.load_state_dict(convert.lm_params_from_numpy(
        np_want["params"], cfg, "cpu").state_dict())
    tr.opt = convert.opt_state_from_numpy(np_want["opt"], cfg, "cpu")
    tr.step = STEP
    tr.save(block=True)
    assert manifest(tdir) == manifest(jdir)
    leaves = manifest(jdir)["leaves"]
    assert any(m["dtype"] == "bfloat16" for m in leaves.values())
    assert any(m["dtype"] == "float32" for m in leaves.values())
    for meta in leaves.values():
        files = [os.path.join(d, f"step_{STEP:08d}", meta["file"])
                 for d in (jdir, tdir)]
        assert open(files[0], "rb").read() == open(files[1], "rb").read()

    # the port restores the reference's checkpoint ...
    _, restored = port_trainer(layout, jdir)
    assert restored.step == STEP
    assert_equal_trees(convert.lm_params_to_numpy(restored.params, cfg),
                       np_want["params"])
    got_opt = convert.opt_state_to_numpy(restored.opt, cfg)
    assert int(got_opt["step"]) == STEP
    assert_equal_trees(got_opt["mu"], np_want["opt"].mu)
    assert_equal_trees(got_opt["nu"], np_want["opt"].nu)
    # ... and the reference restores the port's
    back = RCK.CheckpointManager(tdir).restore(STEP, want)
    assert_equal_trees(back, want)
