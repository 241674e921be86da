"""Training driver: checkpoint/restart, heartbeats, straggler monitoring.

Library use (tests, examples) and CLI:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --preset smoke|100m|full --steps 50 --batch 8 --seq 128 \\
        [--ckpt-dir /tmp/run1] [--compress-dp] [--device cuda]

The JAX package's ``launch/train.py`` with eager autograd in place of
``jax.value_and_grad`` + ``jit``. Fault-tolerance contract: batches are a
pure function of (seed, step); AdamW is deterministic; the backward pass
runs under ``torch.use_deterministic_algorithms(True)`` (the embedding
gather's backward, the loss's ``take_along_dim`` and MoE's ``index_add_``
accumulate in a nondeterministic order by default); so crash →
restore-latest → replay yields bit-identical training. On a card that
mode needs ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the environment before
the process's first cuBLAS call: the CLI sets it, and a Trainer on a card
refuses to start without it.

``compress_dp`` swaps the exact gradient for the explicit int8 wire
protocol (:func:`repro_torch.dist.collectives.compressed_psum_grads`)
over the data group of a :class:`~repro_torch.launch.mesh.HostGrid` (the
reference's ``mesh=``; a one-rank grid when none is given): each rank
takes its contiguous row block of the step's batch, and every replica
ends with the same bits. The quantization seed is a pure function of
(seed, step), so the replay contract survives. Gradients are compressed
in the reference's leaves (a stacked layout's layers joined into one
leaf), so the blocks and scales are the reference's.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from typing import Optional

import torch

from repro_torch import convert
from repro_torch.ckpt import CheckpointManager
from repro_torch.core.context import resolve_device
from repro_torch.data import SyntheticLM
from repro_torch.dist import comm
from repro_torch.dist.collectives import compressed_psum_grads, step_seed
from repro_torch.launch.mesh import HostGrid, single_grid
from repro_torch.models import init_params, loss_fn
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (
    OptState, adamw_init, adamw_update, warmup_cosine,
)
from repro_torch.runtime import FailureInjector, Heartbeat, StepMonitor

__all__ = ["TrainConfig", "Trainer", "run_with_restarts", "main",
           "deterministic", "CUBLAS_WORKSPACE_CONFIG"]

# cuBLAS's deterministic workspace setting (read by torch when it first
# sizes the cuBLAS workspace)
CUBLAS_WORKSPACE_CONFIG = ":4096:8"


@dataclasses.dataclass
class TrainConfig:
    batch: int = 8
    seq_len: int = 64
    steps: int = 20
    peak_lr: float = 3e-4
    warmup_steps: int = 10
    ckpt_every: int = 5
    keep: int = 3
    seed: int = 0


@contextlib.contextmanager
def deterministic():
    """torch.use_deterministic_algorithms(True) (the error mode) for the
    block, then the previous setting."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _meta(named: dict) -> dict:
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in named.items()}


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 ckpt_dir: Optional[str] = None,
                 grid: Optional[HostGrid] = None,
                 injector: Optional[FailureInjector] = None,
                 compress_dp: bool = False,
                 device: str | torch.device = "cuda"):
        """Trains on `grid`'s device when a grid is given, else on
        `device` (default the card; raises without CUDA)."""
        dev = grid.device if grid is not None else resolve_device(device)
        if dev.type == "cuda" and os.environ.get(
                "CUBLAS_WORKSPACE_CONFIG") not in (":4096:8", ":16:8"):
            raise RuntimeError(
                f"replay on a card needs CUBLAS_WORKSPACE_CONFIG="
                f"{CUBLAS_WORKSPACE_CONFIG} set before the process's "
                f"first cuBLAS call")
        self.cfg = cfg
        self.tc = tc
        if compress_dp and grid is None:
            grid = single_grid(dev)
        self.grid = grid
        self.device = dev
        self.compress_dp = compress_dp
        self.injector = injector
        self.data = SyntheticLM(cfg, tc.batch, tc.seq_len, seed=tc.seed,
                                device=dev)
        self.monitor = StepMonitor()
        self.heartbeat = None
        self.ckpt = CheckpointManager(ckpt_dir, keep=tc.keep) \
            if ckpt_dir else None
        # every replica holds the same state: rank 0 writes it
        self._writes = grid is None or grid.rank == 0
        if ckpt_dir and self._writes:
            self.heartbeat = Heartbeat(os.path.join(ckpt_dir, "heartbeat"),
                                       interval=0.0)
        if compress_dp and tc.batch % grid.data:
            raise ValueError(
                f"the data axis ({grid.data}) must divide batch={tc.batch} "
                f"(each shard needs an integral per-rank batch)")

        self.params = init_params(
            cfg, torch.Generator(device=dev).manual_seed(tc.seed), dev)
        self.opt = adamw_init(self.params)
        self.step = 0
        # the reference's flatten order: its gradient norm sums leaves so
        self._order = convert.lm_order(
            [k for k, _ in self.params.named_parameters()], cfg)
        if self.ckpt and self.ckpt.latest_step() is not None:
            self._restore(self.ckpt.latest_step())

    # ---- state ------------------------------------------------------------

    def _state_tree(self) -> dict:
        """{"params", "opt"} in the reference's tree, on the host."""
        def host(named):
            return convert.lm_tree({k: v.detach().to("cpu")
                                    for k, v in named.items()}, self.cfg)
        return {"params": host(dict(self.params.named_parameters())),
                "opt": OptState(step=self.opt.step.to("cpu"),
                                mu=host(self.opt.mu), nu=host(self.opt.nu))}

    def _restore(self, step: int) -> None:
        cfg = self.cfg
        named = dict(self.params.named_parameters())
        template = {"params": convert.lm_tree(_meta(named), cfg),
                    "opt": OptState(
                        step=torch.empty((), dtype=torch.int32,
                                         device="meta"),
                        mu=convert.lm_tree(_meta(self.opt.mu), cfg),
                        nu=convert.lm_tree(_meta(self.opt.nu), cfg))}
        state = self.ckpt.restore(step, template)
        with torch.no_grad():
            for dst, tree in ((named, state["params"]),
                              (self.opt.mu, state["opt"].mu),
                              (self.opt.nu, state["opt"].nu)):
                for k, v in convert.lm_untree(tree, cfg).items():
                    dst[k].copy_(v)
        self.opt.step = state["opt"].step.to(self.device)
        self.step = step

    # ---- one step -----------------------------------------------------------

    def _grads(self, batch: dict) -> tuple[dict, torch.Tensor]:
        """({name: gradient} in the reference's order, the loss)."""
        cfg = self.cfg
        model = self.params
        model.zero_grad(set_to_none=True)
        if self.compress_dp:
            batch = self.data.shard_slice(batch, self.grid.data_rank,
                                          self.grid.data)
        total, metrics = loss_fn(model, batch, cfg)
        total.backward()
        named = dict(model.named_parameters())
        grads = {k: named[k].grad if named[k].grad is not None
                 else torch.zeros_like(named[k]) for k in self._order}
        loss = metrics["loss"].detach()
        if self.compress_dp:
            mean = compressed_psum_grads(
                convert.lm_stack(grads, cfg), self.grid,
                step_seed(self.tc.seed, self.step))
            per = convert.lm_unstack(mean, cfg)
            grads = {k: per[k] for k in self._order}
            loss = comm.all_reduce(self.grid, loss.clone(), axis="data") \
                / self.grid.data
        return grads, loss

    def _train_step(self, batch: dict) -> dict:
        grads, loss = self._grads(batch)
        tc = self.tc
        lr = warmup_cosine(self.opt.step, peak_lr=tc.peak_lr,
                           warmup_steps=tc.warmup_steps,
                           total_steps=tc.steps)
        _, self.opt, od = adamw_update(grads, self.opt, self.params, lr=lr)
        self.params.zero_grad(set_to_none=True)
        return {"loss": loss, **od}

    def run(self, steps: Optional[int] = None) -> dict:
        steps = steps if steps is not None else self.tc.steps
        history = []
        with deterministic():
            while self.step < steps:
                t0 = time.time()
                if self.injector:
                    # inside the timed region: stragglers must show up in
                    # the step wall-time the monitor sees (hard failures
                    # raise before any state mutation, so
                    # restart-from-ckpt is clean)
                    self.injector.maybe_fail(self.step)
                batch = self.data.batch_at(self.step)
                m = self._train_step(batch)
                _sync(self.device)
                dt = time.time() - t0
                self.step += 1
                loss = float(m["loss"])
                breach = self.monitor.record(self.step, dt)
                history.append({"step": self.step, "loss": loss,
                                "sec": dt, "straggler": breach})
                if self.heartbeat:
                    self.heartbeat.beat(self.step, {"loss": loss})
                if self.ckpt and self.step % self.tc.ckpt_every == 0:
                    self.save()
        if self.ckpt:
            self.save(block=True)
        return {"history": history,
                "breaches": list(self.monitor.breaches)}

    def save(self, block: bool = False) -> None:
        if not self._writes:
            return
        self.ckpt.save(self.step, self._state_tree(), block=block)
        self.ckpt.wait() if block else None


def run_with_restarts(make_trainer, total_steps: int, max_restarts: int = 3):
    """Supervisor loop: restart-from-latest on (simulated) node failure."""
    from repro_torch.runtime.failures import SimulatedFailure
    restarts = 0
    trainer = make_trainer()
    while True:
        try:
            out = trainer.run(total_steps)
            return trainer, out, restarts
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            trainer = make_trainer()   # restores from latest checkpoint


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress-dp", action="store_true",
                    help="int8-compressed gradient all-reduce over the "
                         "data axis (dist.collectives; 4× less DP "
                         "traffic, replicas stay bit-identical)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    # before the first cuBLAS call of this process
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)

    from repro_torch.configs.registry import get_arch
    full = get_arch(args.arch)
    if args.preset == "smoke":
        cfg = full.reduced()
    elif args.preset == "100m":
        cfg = full.reduced(n_layers=8, d_model=768, n_heads=12,
                           n_kv_heads=4, head_dim=64, d_ff=2048,
                           vocab_size=32000, scan_layers=True)
    else:
        cfg = full
    tc = TrainConfig(batch=args.batch, seq_len=args.seq, steps=args.steps)
    trainer = Trainer(cfg, tc, ckpt_dir=args.ckpt_dir,
                      compress_dp=args.compress_dp, device=args.device)
    out = trainer.run()
    first, last = out["history"][0], out["history"][-1]
    print(f"arch={args.arch} preset={args.preset} "
          f"loss {first['loss']:.4f} -> {last['loss']:.4f} "
          f"({len(out['history'])} steps)")


if __name__ == "__main__":
    main()
