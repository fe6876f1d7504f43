"""Fault-tolerant trainer (``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir "$(mktemp -d)"

Wires together the substrate layers the reference's trainer does:
sharded state on a ("data", "model") mesh (``make_host_mesh`` over the
cards of ``--device``, default every CUDA card; ``cpu`` for the plain
versions), placed under ``state_pspecs`` and stepped by
``distributed/shard_train.py`` (on one device the mesh is (1, 1) and
the step is the single-device step, bit for bit), the deterministic
resumable data pipeline, async checkpointing with atomic commit,
watchdog + straggler monitoring and restore-on-start (elastic: restores
onto whatever mesh the devices support).  The state is updated in place
each step.  ``--simulate-failure N`` raises at step N and exits with
code 17, to exercise the restart path end to end.  Without
``--ckpt-dir`` the run checkpoints into a new temporary directory, so it
never resumes another run's state.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
import time

import torch

from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_pipeline
from repro_torch.distributed import shard_train
from repro_torch.distributed.sharding import (ShardingPolicy, device_put,
                                              state_pspecs, to_shardings)
from repro_torch.launch.mesh import make_host_mesh, mesh_axis_sizes
from repro_torch.models import api
from repro_torch.models.frontends import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.fault_tolerance import StragglerMonitor, Watchdog


class SimulatedFailure(RuntimeError):
    pass


def build(cfg, opt_cfg, mesh, policy):
    """(make_state, step_fn, sshard): ``make_state(seed)`` initializes
    the state on the mesh's first device and places it under ``sshard``
    (the state's ``NamedSharding`` tree); ``step_fn(state, batch)`` is
    the sharded step."""
    state_abs = api.init_train_state_abstract(cfg, opt_cfg)
    sspec = state_pspecs(cfg, mesh, state_abs, policy)
    sshard = to_shardings(mesh, sspec)
    first = mesh.devices.flat[0]

    def make_state(seed):
        return device_put(api.init_train_state(cfg, opt_cfg, seed,
                                               device=first),
                          sshard, may_alias=True)

    def step_fn(state, batch):
        return shard_train.train_step(cfg, opt_cfg, state, batch)

    return make_state, step_fn, sshard


def device_pool(device) -> list:
    """The devices of ``--device``: every CUDA card for ``cuda``, else
    the one device named."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory, restored from on start "
                         "(default: a new temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-shards", type=int, default=1)
    ap.add_argument("--simulate-failure", type=int, default=-1)
    ap.add_argument("--watchdog-timeout", type=float, default=300.0)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. to reach ~100M params)")
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (every card, one data rank each), cuda:N "
                         "(that card) or cpu (the plain versions)")
    return ap


def train(argv=None):
    args = _parser().parse_args(argv)
    pool = device_pool(args.device)
    if args.ckpt_dir is None:
        args.ckpt_dir = tempfile.mkdtemp(prefix="repro_ckpt_")

    cfg = get_config(args.arch, smoke=args.smoke)
    over = {}
    if args.d_model:
        over.update(d_model=args.d_model,
                    d_ff=4 * args.d_model,
                    head_dim=args.d_model // cfg.n_heads)
    if args.n_layers:
        over.update(n_layers=args.n_layers)
    if over:
        cfg = dataclasses.replace(cfg, **over)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                          total_steps=args.steps,
                          moment_dtype=cfg.moment_dtype)

    mesh = make_host_mesh(data=len(pool), model=1, devices=pool)
    policy = ShardingPolicy(fsdp=cfg.fsdp)
    print(f"[train] arch={cfg.name} params={cfg.param_count():,} "
          f"mesh={mesh_axis_sizes(mesh)} device={pool[0]} "
          f"ckpt={args.ckpt_dir}", flush=True)

    make_state, step_fn, sshard = build(cfg, opt_cfg, mesh, policy)

    # ---- restore or init -------------------------------------------------
    start_step = 0
    latest = store.latest_step(args.ckpt_dir)
    if latest is not None:
        state, extra = store.restore(
            args.ckpt_dir, api.init_train_state_abstract(cfg, opt_cfg),
            shardings=sshard)
        start_step = int(extra.get("next_step", latest))
        print(f"[train] restored step {latest} -> resuming at {start_step}",
              flush=True)
    else:
        state = make_state(args.seed)

    data = make_pipeline(cfg.vocab_size, args.seq, args.batch,
                         seed=args.seed, n_shards=args.data_shards)
    ckpt = store.AsyncCheckpointer(args.ckpt_dir)
    monitor = StragglerMonitor(
        on_straggler=lambda ev: print(
            f"[straggler] step {ev.step}: {ev.step_time:.3f}s "
            f"({ev.ratio:.1f}x ewma) -> rebalance hook", flush=True))
    dog = Watchdog(args.watchdog_timeout,
                   on_timeout=lambda: print("[watchdog] step timeout — "
                                            "restart from last checkpoint",
                                            flush=True)).start()

    losses = []
    try:
        for step in range(start_step, args.steps):
            if step == args.simulate_failure:
                raise SimulatedFailure(f"injected failure at step {step}")
            t0 = time.time()
            state, metrics = step_fn(state, data[step])
            loss = float(metrics["loss"])
            for dev in set(mesh.devices.flat):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            dt = time.time() - t0
            dog.beat()
            monitor.record(step, dt)
            losses.append(loss)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step {step:5d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['grad_norm']):7.3f} "
                      f"lr {float(metrics['lr']):.2e} {dt*1e3:7.1f} ms",
                      flush=True)
            if step and step % args.ckpt_every == 0:
                ckpt.save(step, state, extra={"next_step": step + 1})
        if not losses:
            dog.stop()
            print(f"[train] done. nothing to train: resumed at step "
                  f"{start_step} of {args.steps}", flush=True)
            return losses
        t_save = time.time()
        ckpt.save(args.steps - 1, state, extra={"next_step": args.steps})
        ckpt.wait()
        print(f"[train] saved step {args.steps - 1} in "
              f"{time.time() - t_save:.2f} s", flush=True)
        dog.stop()
        print(f"[train] done. first loss {losses[0]:.4f} -> "
              f"last {losses[-1]:.4f} (events: "
              f"{len(monitor.events)} stragglers)", flush=True)
        return losses
    except SimulatedFailure as e:
        ckpt.wait()
        dog.stop()
        print(f"[train] FAILURE: {e} — relaunch me to resume from the last "
              f"committed checkpoint", flush=True)
        sys.exit(17)


if __name__ == "__main__":
    train()
