"""The fault drills — executable proof that the elastic runtime, the
serving stack and the transport seam hold under injected faults.

Counterpart of ``mxnet_tpu/fault/drill.py``; the assertions are the JAX
package's.  Usable from tests (``tests/test_torch_drill.py``, the
multi-process ones marked slow as the JAX package marks them) and from
the command line (``python -m mxnet_tpu_torch.fault.drill`` runs the
drills and writes a JSON record):

- :func:`elastic_kill_drill`: training workers are SIGKILLed MID-RUN by
  an injected plan (``elastic.step`` at an exact global step), restarted
  on another width (shrink, then grow), and the stitched loss curve
  must match an uninterrupted oracle; overlapping steps between a victim
  and its successor must agree.
- :func:`fused_sweep_parity_drill`: on each rank's 1/n shard of flat
  fp32 buckets, the sweep kernels (K1a ``sgd_sweep``, K1b
  ``sgd_mom_sweep``, K4 ``adam_sweep``) are BITWISE the per-array plain
  update, params and slots, with ``mxnet_pallas_kernel_calls_total``
  showing they launched (on the card; on the CPU both sides are the
  plain mirrors and nothing launches).  The JAX package also records its
  ``sweep_shard_verdict``; the port has no analysis module yet.
- :func:`chaos_soak`: serving and checkpoints under a seeded plan with
  live traffic: zero lost or duplicated requests, zero incomplete
  checkpoints resolved.
- :func:`multitenant_soak`: two tenants on one hardened server, the
  victim's faults scoped to it and a NaN-poisoned canary: the canary
  rolls back, each tenant's ledger is conserved, the bystander sees no
  failure.
- :func:`fleet_network_soak`: a ``FleetFrontDoor`` over replica
  processes, a dist_async worker process and a checkpoint writer, under
  every network fault kind and two host kills: exactly-once serving and
  training, and a replayable fault timeline.

Where the JAX drills make ONE process whose virtual mesh has the drill's
width, the port's width is a world of that many rank processes over
``torch.distributed`` (gloo when asked for the CPU, NCCL on the cards),
each rank on its own device; a leg's plan is armed in every rank, so
every rank dies at the same step.  Every drill runs on ``ctx`` (default
the current context, ``gpu(0)`` outside a ``with`` block); its child
processes are told the same with ``--ctx``.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

__all__ = ["elastic_kill_drill", "chaos_soak", "multitenant_soak",
           "fleet_network_soak", "kv_worker_main",
           "fused_sweep_parity_drill", "fused_parity_worker_main"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _ctx(ctx):
    """``ctx`` as a Context, the current one when None."""
    from ..context import Context, current_context
    return current_context() if ctx is None else Context(ctx)


def _ctx_arg(ctx):
    """``cpu`` or ``gpu`` for a child's ``--ctx``."""
    return _ctx(ctx).device_type


def _worker_env(plan=None):
    env = dict(os.environ)
    env.pop("MXNET_FAULT_PLAN", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    env.setdefault("OMP_NUM_THREADS", "1")
    if plan is not None:
        env["MXNET_FAULT_PLAN"] = json.dumps(plan)
    return env


# ---------------------------------------------------------------------------
# worlds of rank processes (the port's form of a mesh width)
# ---------------------------------------------------------------------------

def _join(rank, world, init_method, device_type):
    """Join the drill's world as ``rank``: gloo on the CPU, NCCL on
    ``cuda:rank``.  Returns the package and the rank's context."""
    import mxnet_tpu_torch as mx
    on = mx.cpu() if device_type == "cpu" else mx.gpu(rank)
    with on:
        mx.parallel.init_distributed(init_method=init_method,
                                     num_processes=world, process_id=rank,
                                     ctx=on, timeout=120)
    return mx, on


def _run_world(width, argv, workdir, ctx, plan=None, timeout=240):
    """Start ``width`` rank processes of ``python -m
    mxnet_tpu_torch.fault.drill <argv>`` joined by a ``file://`` store in
    ``workdir``, and wait for them.  When one dies the others (waiting in
    a collective) are killed.  Returns ``(rc, stderr tail)``: -SIGKILL
    when a rank died by that signal, else the first non-zero exit, else
    0; a world that outlives ``timeout`` is killed and raises."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store-%d" % time.monotonic_ns())
    procs, logs = [], []
    env = _worker_env(plan)
    try:
        for r in range(width):
            log = open(os.path.join(workdir, "rank%d.log" % r), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-u", "-m", "mxnet_tpu_torch.fault.drill"]
                + list(argv) + ["--rank", str(r), "--world", str(width),
                                "--init", "file://" + store,
                                "--ctx", _ctx_arg(ctx)],
                env=env, cwd=_REPO, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        rcs = [None] * width
        while None in rcs:
            for r, p in enumerate(procs):
                if rcs[r] is None:
                    rcs[r] = p.poll()
            if any(rc not in (None, 0) for rc in rcs):
                break
            if time.monotonic() > deadline:
                raise AssertionError("drill world of %d outlived %d s"
                                     % (width, timeout))
            time.sleep(0.05)
        if -signal.SIGKILL in rcs:
            rc = -signal.SIGKILL
        else:
            rc = next((x for x in rcs if x not in (None, 0)), 0)
        tail = ""
        if rc:
            bad = next(r for r, x in enumerate(rcs) if x not in (None, 0))
            logs[bad].seek(0)
            tail = logs[bad].read()[-3000:]
        return rc, tail
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()


# ---------------------------------------------------------------------------
# the elastic worker (also `python -m mxnet_tpu_torch.fault.drill --worker`)
# ---------------------------------------------------------------------------

def _build_trainer(mx, width, zero=2, ctx=None):
    """A small deterministic dense trainer on a dp=``width`` mesh (the
    first ``width`` ranks of the world).  Stable gluon prefixes
    (``net_``) so every (re)build, in whatever process, gives the same
    parameter names: the restore contract is name-addressed."""
    import numpy as np
    nn = mx.gluon.nn
    with _ctx(ctx):
        mx.random.seed(0)
        net = nn.HybridSequential(prefix="net_")
        with net.name_scope():
            net.add(nn.Dense(32, in_units=16, activation="relu"),
                    nn.Dense(16, in_units=32, activation="relu"),
                    nn.Dense(4, in_units=16))
        net.initialize(mx.init.Zero())
        r = np.random.RandomState(42)
        for _, p in sorted(net.collect_params().items()):
            p.set_data(mx.nd.array((r.randn(*p.shape) * 0.2).astype(
                np.float32)))
        mesh = mx.parallel.make_mesh(dp=width, devices=list(range(width)))
        return mx.parallel.ParallelTrainer(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.1, "momentum": 0.9}, mesh=mesh, zero=zero,
            bucket_bytes=2048)


def _drill_data_fn(mx, ctx=None, batch=16):
    """Batches that are a pure function of the step (the replay-exactness
    contract)."""
    import numpy as np
    rng = np.random.RandomState(7)
    X = rng.randn(256, 16).astype(np.float32)
    Y = rng.randint(0, 4, 256).astype(np.float32)

    def data_fn(step):
        i = (step * batch) % 256
        with _ctx(ctx):
            return mx.nd.array(X[i:i + batch]), mx.nd.array(Y[i:i + batch])

    return data_fn


def worker_main(width, steps, ckpt_dir, loss_log, rank=0, init_method=None,
                device_type="gpu"):
    """One rank of an elastic training world of ``width``: resume from
    the latest checkpoint, run to ``steps``, rank 0 logging the losses.
    The plan in ``MXNET_FAULT_PLAN`` may SIGKILL it mid-run."""
    from .elastic import run_elastic
    mx, on = _join(rank, width, init_method, device_type)
    try:
        with on:
            losses = run_elastic(
                lambda restart: _build_trainer(mx, width, ctx=on),
                _drill_data_fn(mx, on), steps, ckpt_dir,
                loss_log=loss_log if rank == 0 else None)
    finally:
        mx.parallel.distributed.shutdown()
    print("drill-worker: completed %d steps on width %d" % (steps, width))
    return losses


def _read_loss_log(path):
    out = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rec = json.loads(line)
                out[int(rec["step"])] = float(rec["loss"])
    return out


def _run_worker(width, steps, ckpt_dir, loss_log, workdir, ctx, plan=None,
                timeout=240):
    return _run_world(width, ["--worker", "--steps", str(steps), "--ckpt",
                              ckpt_dir, "--loss-log", loss_log],
                      workdir, ctx, plan=plan, timeout=timeout)


# the parity drill's optimizers: (class in ``parallel.optimizer``, kwargs)
PARITY_OPTIMIZERS = (("PureSGD", {"learning_rate": 0.1, "wd": 0.01}),
                     ("PureSGD", {"learning_rate": 0.1, "momentum": 0.9,
                                  "wd": 0.01}),
                     ("PureAdam", {"learning_rate": 1e-3, "wd": 0.01}))


def fused_parity_worker_main(report_path, rank=0, world=1, init_method=None,
                             device_type="gpu"):
    """One rank of the fused-sweep parity witness: on this rank's 1/n
    shard of two flat fp32 buckets, SGD, momentum SGD and Adam through the
    sweep kernels (``MXNET_PALLAS_FUSED_OPT=1``) must be BITWISE the
    plain per-array update (``0``), params and slots, after four steps;
    rank 0 writes the record, and beside it (``.npz``) its shard's
    parameters, gradients and per-array results, ``o<j>/<name>/b<i>``
    for optimizer ``j`` of :data:`PARITY_OPTIMIZERS`."""
    import numpy as np
    import torch
    from .. import telemetry
    from ..ops import cuda_kernels as ck
    from ..parallel import optimizer as popt
    mx, on = _join(rank, world, init_method, device_type)
    try:
        telemetry.enable()
        dev = on.torch_device
        sizes = [8 * 2048, 8192]
        rng = np.random.RandomState(5)
        saved = os.environ.get("MXNET_PALLAS_FUSED_OPT")

        def buckets():
            # every rank draws the whole buckets and keeps its shard
            out = {}
            for i, n in enumerate(sizes):
                full = rng.randn(n).astype(np.float32)
                s = n // world
                out["b%d" % i] = torch.from_numpy(
                    full[rank * s:(rank + 1) * s].copy()).to(dev)
            return out

        bit_equal = True
        shard = {}
        ck.reset_kernel_calls()
        for j, (cls, kw) in enumerate(PARITY_OPTIMIZERS):
            opt = getattr(popt, cls)(**kw)
            params = buckets()
            grads = [buckets() for _ in range(4)]

            def drive(knob):
                os.environ["MXNET_PALLAS_FUSED_OPT"] = knob
                p = {k: v.clone() for k, v in params.items()}
                s = opt.init(p)
                for g in grads:
                    p, s = opt.apply(p, g, s, flat=True)
                return p, s

            pf, sf = drive("1")     # the sweep kernels on the card
            pu, su = drive("0")     # the per-array plain update
            for k in params:
                bit_equal &= bool(torch.equal(pf[k].view(torch.int32),
                                              pu[k].view(torch.int32)))
            for a, b in zip(_leaves(sf), _leaves(su)):
                bit_equal &= bool(torch.equal(a.view(torch.int32),
                                              b.view(torch.int32)))
            for name, tree in [("params", params), ("out", pu)] + [
                    ("grad%d" % t, g) for t, g in enumerate(grads)]:
                for k, v in tree.items():
                    shard["o%d/%s/%s" % (j, name, k)] = v.cpu().numpy()
        if saved is None:
            os.environ.pop("MXNET_PALLAS_FUSED_OPT", None)
        else:
            os.environ["MXNET_PALLAS_FUSED_OPT"] = saved
        fam = telemetry.snapshot().get("mxnet_pallas_kernel_calls_total",
                                       {"values": []})
        calls = {dict(v["labels"])["kernel"]: v["value"]
                 for v in fam["values"]}
        record = {"mesh": "dp%d" % world, "rank": rank,
                  "device": str(dev),
                  "bitwise_equal_vs_per_array": bit_equal,
                  "pallas_kernel_calls": calls,
                  "launches": {k: v for k, v in ck.kernel_calls().items()
                               if v}}
        if rank == 0:
            record["shard_arrays"] = os.path.splitext(report_path)[0] \
                + ".npz"
            np.savez(record["shard_arrays"], **shard)
            with open(report_path, "w") as f:
                json.dump(record, f, indent=1)
                f.write("\n")
        print("drill-worker: fused parity rank %d bitwise=%s calls=%s"
              % (rank, bit_equal, sorted(calls)))
        return 0 if bit_equal else 1
    finally:
        mx.parallel.distributed.shutdown()


def _leaves(tree):
    """The tensors of a nested optimizer state, in a fixed order."""
    import torch
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def fused_sweep_parity_drill(tmpdir=None, timeout=240, world=None,
                             ctx=None):
    """Run :func:`fused_parity_worker_main` in a world of ``world`` rank
    processes (default: every card, one rank a card, on the GPU; 8 ranks
    on the CPU) and assert the record's bars: bitwise equal on every
    rank, and on the card the kernels' launches counted."""
    import torch
    tmpdir = tmpdir or tempfile.mkdtemp(prefix="mx_fused_parity_")
    on_card = _ctx(ctx).device_type == "gpu"
    if world is None:
        world = torch.cuda.device_count() if on_card else 8
    report_path = os.path.join(tmpdir, "fused_parity.json")
    rc, tail = _run_world(world, ["--fused-parity-worker", "--report",
                                  report_path],
                          os.path.join(tmpdir, "world"), ctx,
                          timeout=timeout)
    if rc != 0 or not os.path.exists(report_path):
        raise AssertionError("fused parity worker failed rc=%s:\n%s"
                             % (rc, tail))
    with open(report_path) as f:
        record = json.load(f)
    assert record["bitwise_equal_vs_per_array"], record
    calls = record["pallas_kernel_calls"]
    if on_card:
        assert calls.get("fused_sgd", 0) >= 1, calls
        assert calls.get("fused_sgd_momentum", 0) >= 1, calls
        assert calls.get("fused_adam", 0) >= 1, calls
    return record


def elastic_kill_drill(steps=12, kill_at=(4, 8), widths=(4, 2, 8),
                       tmpdir=None, atol=0.0, ctx=None):
    """Kill-and-reshard drill (see the module docstring).

    ``widths[0]`` ranks run until the plan SIGKILLs them at global step
    ``kill_at[0]``; ``widths[1]`` (shrink) resume and die at
    ``kill_at[1]``; ``widths[2]`` (grow) resume and finish.  The oracle
    is ``widths[0]`` uninterrupted.  Returns the report dict; raises
    AssertionError on any violated invariant.

    ``atol``: a same-width resume is bit-identical, so an all-equal
    ``widths`` drill runs with ``atol=0``; a width CHANGE changes how the
    post-restore gradient sums associate, so pass an ``atol`` a few ulps
    wide and read ``max_loss_dev_vs_oracle``."""
    own = tmpdir is None
    tmpdir = tmpdir or tempfile.mkdtemp(prefix="mx-drill-")
    report = {"steps": steps, "kill_at": list(kill_at),
              "widths": list(widths), "legs": []}
    try:
        # -- oracle: uninterrupted run at the starting width ----------------
        oracle_log = os.path.join(tmpdir, "oracle.jsonl")
        rc, tail = _run_worker(widths[0], steps,
                               os.path.join(tmpdir, "ck-o"), oracle_log,
                               os.path.join(tmpdir, "w-o"), ctx)
        assert rc == 0, "oracle run failed rc=%s:\n%s" % (rc, tail)
        oracle = _read_loss_log(oracle_log)
        assert len(oracle) == steps, "oracle logged %d/%d steps" % (
            len(oracle), steps)

        # -- elastic chain: kill, shrink, kill, grow ------------------------
        # the respawn loop is the runtime's (ProcessSupervisor): each
        # SIGKILL death is recoverable and the next attempt launches on
        # the next width in the schedule
        from .backoff import BackoffPolicy
        from .elastic import ProcessSupervisor
        ckpt = os.path.join(tmpdir, "ck-e")
        runs = [
            (widths[0], {"rules": [{"site": "elastic.step",
                                    "kind": "sigkill",
                                    "step": int(kill_at[0])}]}),
            (widths[1], {"rules": [{"site": "elastic.step",
                                    "kind": "sigkill",
                                    "step": int(kill_at[1])}]}),
            (widths[2], None),
        ]
        logs = []

        def launch(restart):
            width, plan = runs[min(restart, len(runs) - 1)]
            log = os.path.join(tmpdir, "leg%d.jsonl" % restart)
            logs.append(log)
            rc, tail = _run_worker(width, steps, ckpt, log,
                                   os.path.join(tmpdir, "w%d" % restart),
                                   ctx, plan=plan)
            report["legs"].append(
                {"width": width, "rc": rc,
                 "killed": rc == -signal.SIGKILL,
                 "steps_logged": sorted(_read_loss_log(log))})
            if plan is not None:
                assert rc == -signal.SIGKILL, \
                    "leg %d expected SIGKILL death, got rc=%s:\n%s" % (
                        restart, rc, tail)
            else:
                assert rc == 0, "final leg failed rc=%s:\n%s" % (rc, tail)
            return rc

        ProcessSupervisor(
            retries=len(runs),
            backoff=BackoffPolicy(retries=0, base_s=0.01, max_s=0.02,
                                  jitter=0.0, seed=0)).run(launch)

        # -- invariants ------------------------------------------------------
        # stitch: later legs win on overlap, but overlapping steps must
        # AGREE between victim and successor
        stitched = {}
        for log in logs:
            for s, l in _read_loss_log(log).items():
                if s in stitched:
                    assert abs(stitched[s] - l) <= atol, \
                        "replayed step %d diverged: %r vs %r" % (
                            s, stitched[s], l)
                stitched[s] = l
        assert sorted(stitched) == list(range(steps)), \
            "stitched curve has holes: %s" % sorted(stitched)
        dev = max(abs(stitched[s] - oracle[s]) for s in range(steps))
        assert dev <= atol, \
            "loss curve deviates from uninterrupted oracle by %g" % dev
        report["max_loss_dev_vs_oracle"] = dev
        report["loss_curve_matches_oracle"] = True
        report["oracle_losses"] = [oracle[s] for s in range(steps)]
        return report
    finally:
        if own:
            import shutil
            shutil.rmtree(tmpdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# chaos soak — serving + checkpoint stack under a pseudo-random plan
# ---------------------------------------------------------------------------

SOAK_PLAN = {
    "seed": 7,
    "rules": [
        # transient executor-cache failures: poison the batch, not the
        # batcher
        {"site": "serving.cache.get", "kind": "raise", "exc":
         "RuntimeError", "p": 0.05, "times": 0},
        # batcher hiccups: latency, not loss
        {"site": "serving.worker", "kind": "delay", "delay_s": 0.01,
         "p": 0.1, "times": 0},
        # checkpoint commits fail transiently; the NEXT save retries
        {"site": "checkpoint.store.commit", "kind": "io_error",
         "p": 0.25, "times": 0},
        # watcher polls and manifest reads hit flaky-filesystem weather
        {"site": "checkpoint.watcher.poll", "kind": "io_error",
         "p": 0.15, "times": 0},
        {"site": "checkpoint.store.manifest_read", "kind": "io_error",
         "p": 0.1, "times": 0},
    ],
}


def chaos_soak(duration_s=8.0, clients=4, tmpdir=None, ctx=None):
    """Drive the serving + checkpoint stack under :data:`SOAK_PLAN`
    (see module docstring for the invariants) on ``ctx`` (default the
    current context).  Returns the report dict; raises AssertionError on
    a violated invariant."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import fault
    from mxnet_tpu_torch.checkpoint import (CheckpointError,
                                            CheckpointManager,
                                            IntegrityError)
    from mxnet_tpu_torch.serving.errors import ServingError
    ctx = _ctx(ctx)

    own = tmpdir is None
    tmpdir = tmpdir or tempfile.mkdtemp(prefix="graftfault-soak-")
    ckpt_dir = os.path.join(tmpdir, "ck")

    # a small trained module: the checkpoint writer snapshots it, the
    # watcher hot-swaps the committed versions into the server
    mod = _soak_module(seed=0, ctx=ctx)
    mgr = CheckpointManager(directory=ckpt_dir, async_save=False,
                            keep_last=4)

    srv = mx.serving.ModelServer(max_batch=8, batch_wait_ms=1.0,
                                 queue_depth=32,
                                 default_timeout_ms=30000.0, ctx=ctx)
    mod.export_serving("m", srv)
    srv.start()
    srv.warmup("m")
    watcher = srv.watch_checkpoints(ckpt_dir, "m", poll_interval=0.2)

    stop = threading.Event()
    counts = {"submitted": 0, "served": 0, "typed_failures": 0,
              "lost": 0, "duplicated": 0}
    counts_lock = threading.Lock()
    commit_attempts = [0, 0]       # attempts, failures
    integrity_failures = []
    reader_polls = [0]

    def writer():
        i = 0
        while not stop.is_set():
            i += 1
            commit_attempts[0] += 1
            try:
                mgr.save_module(mod, epoch=i, block=True)
            except (OSError, CheckpointError):
                commit_attempts[1] += 1   # injected commit/manifest
                # fault; next period retries — the drill point
            stop.wait(0.15)

    def reader():
        """Any checkpoint a reader can RESOLVE must be complete:
        integrity failures on committed directories are the violation
        this soak exists to catch (transient injected IO errors are
        weather, not a violation)."""
        while not stop.is_set():
            steps_now = mgr.store.steps()
            if steps_now:
                reader_polls[0] += 1
                try:
                    mgr.store.read(steps_now[-1], verify=True)
                except IntegrityError as exc:
                    integrity_failures.append(str(exc))
                except (OSError, ValueError, CheckpointError):
                    pass   # injected transient weather (a manifest
                    # fault surfaces as CheckpointError, not OSError)
            stop.wait(0.05)

    def client(ci):
        """Every submission must RESOLVE exactly once: a result, a
        typed rejection, or the poisoning fault delivered to THIS
        request's future.  ``lost`` counts futures that never resolve
        (a hang is the failure mode backpressure bugs produce);
        ``duplicated`` counts futures observed already-done before this
        client ever waited — a double delivery."""
        crng = np.random.RandomState(100 + ci)
        while not stop.is_set():
            rows = 1 + int(crng.randint(0, 5))
            with counts_lock:
                counts["submitted"] += 1
            try:
                fut = srv.infer_async(
                    "m", crng.randn(rows, 8).astype(np.float32),
                    retries=2)
            except ServingError:
                with counts_lock:
                    counts["typed_failures"] += 1
                continue
            if not fut.wait(25.0):
                with counts_lock:
                    counts["lost"] += 1   # never resolved: the hang class
                continue
            try:
                outs = fut.result()
                assert outs[0].shape[0] == rows
                with counts_lock:
                    counts["served"] += 1
            except Exception:
                # delivered failure (injected bind fault, deadline):
                # the future resolved — a TYPED outcome, not a loss
                with counts_lock:
                    counts["typed_failures"] += 1

    threads = [threading.Thread(target=writer, daemon=True),
               threading.Thread(target=reader, daemon=True)]
    threads += [threading.Thread(target=client, args=(ci,), daemon=True)
                for ci in range(clients)]

    plan = fault.FaultPlan(SOAK_PLAN)
    try:
        with fault.active_plan(plan):
            for t in threads:
                t.start()
            time.sleep(duration_s)
            stop.set()
            for t in threads:
                t.join(timeout=30)
        watcher.stop()
        srv.stop(drain=False)
    finally:
        if not stop.is_set():
            stop.set()

    # -- invariants ----------------------------------------------------------
    stats = srv.stats()
    resolved = counts["served"] + counts["typed_failures"]
    assert counts["lost"] == 0, \
        "%d futures never resolved (hung requests)" % counts["lost"]
    assert resolved == counts["submitted"], \
        "lost requests: %d submitted, %d resolved" % (counts["submitted"],
                                                      resolved)
    # server-side conservation: every ACCEPTED request lands in exactly
    # one terminal outcome — a double delivery (or a dropped one) would
    # unbalance this ledger
    sreq = stats["requests"]
    assert sreq["submitted"] == sreq["served"] + sreq["failed"] \
        + sreq["expired"] + sreq["shed"], \
        "server request ledger unbalanced (duplicate or dropped " \
        "delivery): %s" % sreq
    assert not integrity_failures, \
        "INCOMPLETE checkpoint visible to a reader: %s" % \
        integrity_failures[:3]
    injected = plan.stats()
    assert injected["injected"], "soak injected nothing — plan dead?"
    served_versions = stats["models"]["m"]["versions"]
    report = {
        "duration_s": duration_s,
        "requests": dict(counts),
        "server_stats": {k: stats[k] for k in ("requests", "queue")},
        "checkpoints": {
            "commit_attempts": commit_attempts[0],
            "commit_failures_injected": commit_attempts[1],
            "complete_on_disk": len(mgr.store.steps()),
            "reader_polls": reader_polls[0],
            "integrity_failures": len(integrity_failures),
            "versions_hot_swapped": len(served_versions),
        },
        "faults_injected": {
            "total": len(injected["injected"]),
            "by_site": {s: sum(1 for i in injected["injected"]
                               if i["site"] == s)
                        for s in sorted({i["site"]
                                         for i in injected["injected"]})},
        },
        "zero_lost_requests": True,
        "zero_duplicated_requests": True,   # the ledger assertion above
        "zero_incomplete_checkpoint_reads": True,
    }
    if own:
        import shutil
        shutil.rmtree(tmpdir, ignore_errors=True)
    return report


VICTIM, BYSTANDER = "tenantA", "tenantB"

MT_PLAN = {
    "seed": 11,
    "rules": [
        # the victim's executor binds fail transiently: its batches
        # poison, its quota'd cache slots churn — the bystander's must
        # not
        {"site": "serving.cache.get", "kind": "raise",
         "exc": "RuntimeError", "p": 0.05, "times": 0,
         "where": {"model": VICTIM}},
        # victim batches run slow (brownout pressure feed)
        {"site": "serving.worker", "kind": "delay", "delay_s": 0.005,
         "p": 0.1, "times": 0, "where": {"model": VICTIM}},
        # the poisoned canary: EVERY canary-version batch of the victim
        # silently emits NaNs — the health gate's non-finite sentinel,
        # not any exception handler, must roll it back
        {"site": "serving.canary.execute", "kind": "nan", "times": 0,
         "where": {"model": VICTIM}},
    ],
}


def _soak_module(seed=0, ctx=None):
    """The small trained module the soaks checkpoint and hot-swap from,
    on ``ctx``."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import sym
    ctx = _ctx(ctx)
    rng = np.random.RandomState(seed)
    X = rng.randn(64, 8).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    train = mx.io.NDArrayIter(X, y, batch_size=16)
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=2, name="fc2")
    net = sym.SoftmaxOutput(net, name="softmax")
    mod = mx.mod.Module(net, context=ctx)
    mod.fit(train, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05}, eval_metric="acc")
    return mod


def multitenant_soak(duration_s=8.0, clients_victim=3, clients_bystander=1,
                     canary_fraction=0.3, tmpdir=None, ctx=None):
    """Two tenants, one hardened server, tenant-scoped faults + one
    poisoned canary (see module docstring for the invariants), on
    ``ctx`` (default the current context).  Returns the report dict;
    raises AssertionError on any violation."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import fault
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.serving.errors import ServingError
    ctx = _ctx(ctx)

    own = tmpdir is None
    tmpdir = tmpdir or tempfile.mkdtemp(prefix="graftfault-mt-")
    ckpt_dir = os.path.join(tmpdir, "ck")

    # graftrace rides the soak: full-sample tracing plus the flight
    # recorder, so the rollback below must leave a self-contained
    # post-mortem artifact — invariant (6) reads it back
    from mxnet_tpu_torch.telemetry import flight, tracing
    trace_dir = os.path.join(tmpdir, "traces")
    os.makedirs(trace_dir, exist_ok=True)
    trace_was_on = tracing.enabled()
    tracing.reset()
    flight.reset()
    # p99_factor sky-high: anomaly must come ONLY from injected faults
    # and failed requests, so the bystander-stays-clean trace assertion
    # cannot trip on scheduling-latency noise
    tracing.enable(sample=1.0, trace_dir=trace_dir, p99_factor=1e9)

    mod_v = _soak_module(seed=0, ctx=ctx)   # the victim (checkpoint source)
    mod_b = _soak_module(seed=1, ctx=ctx)   # the bystander

    srv = mx.serving.ModelServer(max_batch=8, batch_wait_ms=1.0,
                                 queue_depth=64,
                                 default_timeout_ms=30000.0,
                                 canary_fraction=canary_fraction, ctx=ctx)
    mod_v.export_serving(VICTIM, srv)
    mod_b.export_serving(BYSTANDER, srv)
    # cache quota sized for the ladder x 2 live versions: a canary
    # transiently doubles the victim's working set, and its binds must
    # evict neither the bystander NOR the victim's own baseline
    ladder = len(srv.stats()["buckets"])
    srv.set_quota(VICTIM, queue_depth=32, cache_entries=2 * ladder)
    srv.set_quota(BYSTANDER, queue_depth=32, cache_entries=ladder)
    srv.start()
    srv.warmup()

    mgr = CheckpointManager(directory=ckpt_dir, async_save=False,
                            keep_last=4)
    # step-1 checkpoint BEFORE the watcher: it aliases the exported
    # version 1 (same weights), so the watcher's first poll is a no-op
    # promote and the MID-SOAK save below claims step 2 — the canary
    mgr.save_module(mod_v, epoch=1, block=True)
    watcher = srv.watch_checkpoints(ckpt_dir, VICTIM, poll_interval=0.2)

    stop = threading.Event()
    counts = {t: {"submitted": 0, "served": 0, "typed_failures": 0,
                  "lost": 0}
              for t in (VICTIM, BYSTANDER)}
    counts_lock = threading.Lock()
    t_start = time.monotonic()
    canary_seen = threading.Event()

    def client(tenant, ci):
        crng = np.random.RandomState(500 + ci)
        mine = counts[tenant]
        while not stop.is_set():
            rows = 1 + int(crng.randint(0, 4))
            with counts_lock:
                mine["submitted"] += 1
            try:
                fut = srv.infer_async(
                    tenant, crng.randn(rows, 8).astype(np.float32),
                    retries=2)
            except ServingError:
                with counts_lock:
                    mine["typed_failures"] += 1
                continue
            if not fut.wait(25.0):
                with counts_lock:
                    mine["lost"] += 1
                continue
            try:
                outs = fut.result()
                assert outs[0].shape[0] == rows
                with counts_lock:
                    mine["served"] += 1
            except Exception:
                # delivered failure (injected bind fault, deadline,
                # poisoned canary outputs raising downstream): the
                # future RESOLVED — a typed outcome, not a loss
                with counts_lock:
                    mine["typed_failures"] += 1

    threads = [threading.Thread(target=client, args=(VICTIM, ci),
                                daemon=True)
               for ci in range(clients_victim)]
    threads += [threading.Thread(target=client, args=(BYSTANDER, 100 + ci),
                                 daemon=True)
                for ci in range(clients_bystander)]

    plan = fault.FaultPlan(MT_PLAN)
    rollback_wall_s = None
    try:
        with fault.active_plan(plan):
            for t in threads:
                t.start()
            # commit ONE new victim checkpoint a beat in: the watcher
            # warms it, stages it as a canary, the plan poisons it
            time.sleep(min(1.0, duration_s / 4.0))
            mgr.save_module(mod_v, epoch=2, block=True)
            t_commit = time.monotonic()
            deadline = t_start + duration_s
            while time.monotonic() < deadline:
                hist = srv.canary_status(VICTIM)["history"]
                if hist and rollback_wall_s is None:
                    rollback_wall_s = time.monotonic() - t_commit
                    canary_seen.set()
                time.sleep(0.1)
            stop.set()
            for t in threads:
                t.join(timeout=30)
        watcher.stop()
        srv.stop(drain=False)
    finally:
        if not stop.is_set():
            stop.set()
        # harvest the trace evidence BEFORE disarming (incident dumps
        # are already on disk; the anomalous set lives in the ring)
        trace_spans = tracing.snapshot()
        trace_anomalous = tracing.anomalous()
        tracing.export_jsonl()
        tracing.disable()
        tracing.reset()
        flight.reset()
        if trace_was_on:
            tracing.enable()   # restore the caller's env-armed state

    # -- invariants ----------------------------------------------------------
    stats = srv.stats()
    per_model = stats["per_model"]
    # (1) per-tenant client-side exactly-once + server-side ledger
    for tenant in (VICTIM, BYSTANDER):
        c = counts[tenant]
        resolved = c["served"] + c["typed_failures"]
        assert c["lost"] == 0, \
            "%s: %d futures never resolved" % (tenant, c["lost"])
        assert resolved == c["submitted"], \
            "%s: %d submitted, %d resolved" % (tenant, c["submitted"],
                                               resolved)
        sreq = per_model[tenant]["requests"]
        assert sreq["submitted"] == sreq["served"] + sreq["failed"] \
            + sreq["expired"] + sreq["shed"], \
            "%s server ledger unbalanced: %s" % (tenant, sreq)
        # (2) quotas respected
        quota = per_model[tenant]["quota"]
        assert per_model[tenant]["queue_peak"] <= quota["queue_depth"], \
            "%s queue peak %d exceeded quota %s" % (
                tenant, per_model[tenant]["queue_peak"], quota)
    # (3) the poisoned canary rolled back; baseline still serving
    hist = srv.canary_status(VICTIM)["history"]
    assert canary_seen.is_set() and hist, \
        "canary never staged/decided — watcher or promotion dead?"
    verdict = hist[-1]
    assert verdict["decision"] == "rolled_back", verdict
    assert verdict["reason"] == "nonfinite_outputs", verdict
    assert srv.registry.get(VICTIM).version == \
        verdict["baseline_version"], \
        "rollback left the wrong default serving"
    # (4) the bystander never suffered: zero failures, zero cache
    # evictions, real throughput throughout
    b = per_model[BYSTANDER]["requests"]
    assert b["failed"] == 0 and b["shed"] == 0, \
        "bystander absorbed the victim's faults: %s" % b
    cache_pm = stats["executor_cache"]["per_model"]
    assert cache_pm.get(BYSTANDER, {}).get("evictions", 0) == 0, \
        "cross-tenant eviction: %s" % cache_pm
    assert counts[BYSTANDER]["served"] > 0
    # (5) every injected fault was scoped to the victim
    injected = plan.stats()
    assert injected["injected"], "soak injected nothing — plan dead?"
    nan_hits = plan.injected_count(site="serving.canary.execute",
                                   kind="nan")
    assert nan_hits >= 1, "the canary was never poisoned"
    # (6) graftrace: the incident flight dump ALONE explains the
    # rollback — the gate's inputs, the decision chain in the event
    # ring, the victim's tail-retained anomalous traces — and the
    # bystander appears in none of it
    dumps = sorted(n for n in os.listdir(trace_dir)
                   if n.startswith("incident-canary_rollback-"))
    assert dumps, "rollback never dumped the flight recorder"
    with open(os.path.join(trace_dir, dumps[0])) as f:
        dump = json.load(f)
    det = dump["detail"]
    assert det["decision"] == "rolled_back" \
        and det["reason"] == "nonfinite_outputs" \
        and det["nonfinite_batches"] >= 1, det
    kinds = {e["kind"] for e in dump["events"]}
    assert "canary_decision" in kinds and "fault" in kinds, \
        "flight ring missing the decision chain: %s" % sorted(kinds)

    def _span_models(spans):
        return {(rec.get("tags") or {}).get("model") for rec in spans}

    assert any(VICTIM in _span_models(sp)
               for sp in dump["traces"].values()), \
        "no victim trace retained in the incident dump"
    for tid, sp in dump["traces"].items():
        assert BYSTANDER not in _span_models(sp), \
            "bystander trace %s retained as anomalous" % tid
    # the post-soak anomalous set agrees: victims only, never the
    # bystander (fault marks + failed roots; p99 noise was disarmed)
    by_trace = {}
    for rec in trace_spans:
        by_trace.setdefault(rec["trace"], []).append(rec)
    victim_anomalous = 0
    for tid in trace_anomalous:
        models = _span_models(by_trace.get(tid, ()))
        assert BYSTANDER not in models, \
            "bystander trace %s marked anomalous" % tid
        if VICTIM in models:
            victim_anomalous += 1
    assert victim_anomalous >= 1, \
        "no anomalous victim trace survived to the post-soak ring"

    wall = time.monotonic() - t_start
    report = {
        "duration_s": round(wall, 2),
        "canary_fraction": canary_fraction,
        "per_tenant": {
            t: {
                "clients": (clients_victim if t == VICTIM
                            else clients_bystander),
                "requests": dict(counts[t]),
                "req_per_sec": round(counts[t]["served"] / wall, 2),
                "p99_ms": per_model[t]["latency_ms"]["p99"],
                "server_ledger": per_model[t]["requests"],
                "queue_peak": per_model[t]["queue_peak"],
                "quota": per_model[t]["quota"],
                "cache": stats["executor_cache"]["per_model"].get(t),
            } for t in (VICTIM, BYSTANDER)},
        "canary": {
            "verdict": verdict,
            "rollback_wall_s": (round(rollback_wall_s, 3)
                                if rollback_wall_s is not None else None),
            "decision_latency_s": verdict["decision_latency_s"],
        },
        "faults_injected": {
            "total": len(injected["injected"]),
            "nan_canary_batches": nan_hits,
            "by_site": {s: sum(1 for i in injected["injected"]
                               if i["site"] == s)
                        for s in sorted({i["site"]
                                         for i in injected["injected"]})},
        },
        "zero_lost_requests_per_tenant": True,
        "zero_duplicated_requests_per_tenant": True,
        "zero_cross_tenant_evictions": True,
        "quotas_respected": True,
        "rolled_back_to_baseline": True,
        "tracing": {
            "incident_dump": dumps[0],
            "flight_events": len(dump["events"]),
            "anomalous_traces": len(trace_anomalous),
            "victim_traces_retained": victim_anomalous,
            "bystander_traces_clean": True,
        },
    }
    if own:
        import shutil
        shutil.rmtree(tmpdir, ignore_errors=True)
    return report


# the MAIN process's weather (traced: the replay witness is asserted on
# this plan).  Sites: the fleet front door's transport (requests out,
# results in), the dist_async coordinator's arrivals, the checkpoint
# store.
FLEET_SOAK_PLAN = {
    "seed": 23,
    "rules": [
        # request link weather: drops, delays, lost acks, reordering —
        # send_reliable + receiver dedup must keep every request
        # exactly-once regardless
        {"site": "transport.send", "kind": "partition", "p": 0.03,
         "times": 0, "where": {"kind": "infer"}},
        {"site": "transport.send", "kind": "slow_link",
         "delay_s": 0.002, "p": 0.12, "times": 0},
        {"site": "transport.send.ack", "kind": "lost_ack", "p": 0.06,
         "times": 0},
        {"site": "transport.recv", "kind": "reorder", "p": 0.06,
         "times": 0},
        {"site": "transport.recv", "kind": "slow_link",
         "delay_s": 0.001, "p": 0.08, "times": 0},
        # gradient arrivals at the dist_async coordinator ride the same
        # seam: a receive-side partition leaves them spooled, not lost
        {"site": "transport.recv", "kind": "partition", "p": 0.03,
         "times": 0, "where": {"kind": "grad"}},
        # checkpoint weather rides along (chaos_soak's bars)
        {"site": "checkpoint.store.commit", "kind": "io_error",
         "p": 0.2, "times": 0},
        {"site": "checkpoint.store.manifest_read", "kind": "io_error",
         "p": 0.1, "times": 0},
    ],
}

# the kv WORKER process's plan (shipped via MXNET_FAULT_PLAN): its push
# link takes partitions / slow links / lost acks, and mid-run the plan
# SIGKILLs the whole process at a push entry — the host-death move the
# ProcessSupervisor must recover from without double-applying anything.
KV_WORKER_PLAN = {
    "seed": 31,
    "rules": [
        {"site": "transport.send", "kind": "partition", "p": 0.05,
         "times": 0},
        {"site": "transport.send", "kind": "slow_link",
         "delay_s": 0.002, "p": 0.1, "times": 0},
        {"site": "transport.send.ack", "kind": "lost_ack", "p": 0.1,
         "times": 0},
        {"site": "kvstore.push", "kind": "sigkill", "after": 12,
         "times": 1},
    ],
}

# each replica subprocess gets its own seeded weather on the RESULT
# link: a lost ack there resends the result under one message id and
# the front door's dedup must absorb it (duplicates_dropped, never a
# double delivery)
def _replica_plan(rank):
    return {
        "seed": 40 + rank,
        "rules": [
            {"site": "transport.send", "kind": "slow_link",
             "delay_s": 0.002, "p": 0.05, "times": 0},
            {"site": "transport.send.ack", "kind": "lost_ack",
             "p": 0.05, "times": 0},
        ],
    }


def _write_json(path, obj):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _read_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _kv_report(acked, failed, final):
    """The kv worker's progress record: persisted after EVERY push so a
    SIGKILL loses at most the in-flight one, plus (on clean exit) the
    child's own injection counts and replay witness."""
    from .plan import installed
    rec = {"acked": acked, "failed": failed, "final": final}
    plan = installed()
    if plan is not None:
        injected = plan.stats()["injected"]
        rec["injected"] = len(injected)
        by_kind = {}
        for i in injected:
            by_kind[i["kind"]] = by_kind.get(i["kind"], 0) + 1
        rec["by_kind"] = by_kind
        if final:
            rec["replay_identical"] = (plan.replay() == injected)
    return rec


def kv_worker_main(pushes, report_path, ctx=None):
    """One dist_async training worker under an env-armed plan: push
    unit gradients through the transport seam from ``ctx`` (default the
    current context), persisting progress after each push.  A failed
    push is counted and ABANDONED — a re-push would mint a NEW message
    id, and if the original actually landed (a ``lost_ack`` publishes
    before it raises) the coordinator would apply the gradient twice."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.base import MXNetError
    ctx = _ctx(ctx)

    kv = mx.kv.create("dist_async")
    kv.init("w", nd.zeros((4,), ctx=ctx))
    acked = failed = 0
    for _ in range(int(pushes)):
        try:
            kv.push("w", nd.array(np.ones((4,), np.float32), ctx=ctx))
            acked += 1
        except MXNetError:
            failed += 1
        _write_json(report_path, _kv_report(acked, failed, False))
    _write_json(report_path, _kv_report(acked, failed, True))
    kv.close()
    print("kv-worker: %d acked, %d failed of %d" % (acked, failed, pushes))


def fleet_network_soak(duration_s=10.0, clients=4, replicas=3,
                       kv_pushes=30, min_faults=200, tmpdir=None, ctx=None):
    """The multi-host chaos-soak leg: network-shaped faults + host kills
    over serving AND training concurrently.

    - a :class:`~..serving.fleet.FleetFrontDoor` routes live client
      traffic across ``replicas`` ModelServer PROCESSES; mid-soak one
      replica is SIGKILLed — in-flight requests resubmit under their
      original ids and the fleet ledger stays exactly-once (zero lost,
      zero duplicated);
    - a dist_async pair trains concurrently: a worker process pushes
      gradients under :data:`KV_WORKER_PLAN`, which SIGKILLs it
      mid-push; :class:`~.elastic.ProcessSupervisor` relaunches it and
      the coordinator's dedup keeps every delivered gradient applied
      exactly once (weight delta cross-checked);
    - a checkpoint writer/reader pair runs under commit/manifest IO
      faults: zero incomplete-checkpoint reads;
    - the main plan is TRACED: the soak extends itself (bounded) until
      ``min_faults`` total injections spanning all four network kinds,
      then asserts ``plan.replay() == plan.stats()["injected"]`` — the
      same plan + seed replays to the identical fault timeline.

    Everything runs on ``ctx`` (default the current context): the
    replicas, the kv worker, and this process's coordinator and module.
    """
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import fault, nd
    from mxnet_tpu_torch.checkpoint import (CheckpointError,
                                            CheckpointManager,
                                            IntegrityError)
    from mxnet_tpu_torch.serving.errors import ServingError
    from mxnet_tpu_torch.serving.fleet import FleetFrontDoor, spawn_replica
    from .backoff import BackoffPolicy
    from .elastic import ProcessSupervisor
    ctx = _ctx(ctx)

    own = tmpdir is None
    tmpdir = tmpdir or tempfile.mkdtemp(prefix="graftfault-fleet-")
    fleet_root = os.path.join(tmpdir, "fleet")
    kv_root = os.path.join(tmpdir, "kv")
    ckpt_dir = os.path.join(tmpdir, "ck")
    os.makedirs(fleet_root, exist_ok=True)
    os.makedirs(kv_root, exist_ok=True)

    plan = fault.FaultPlan(FLEET_SOAK_PLAN, trace=True)

    # -- the serving fleet: front door + N process replicas ------------------
    world = replicas + 1
    fd = FleetFrontDoor(fleet_root, world, request_timeout_s=5.0,
                        health_interval_s=0.1)
    handles = [fd.add_replica(
        spawn_replica(fleet_root, r + 1, world, seed=0,
                      fault_plan=_replica_plan(r + 1), ctx=ctx))
               for r in range(replicas)]

    # -- the dist_async coordinator (training side) --------------------------
    kv_env = {"MXNET_KVSTORE_ASYNC_DIR": kv_root,
              "DMLC_WORKER_ID": "0", "DMLC_NUM_WORKER": "2"}
    saved = {k: os.environ.get(k) for k in kv_env}
    os.environ.update(kv_env)
    try:
        kv = mx.kv.create("dist_async")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    kv._set_updater(lambda i, g, w: w.__isub__(0.1 * g))
    kv.init("w", nd.zeros((4,), ctx=ctx))

    kv_reports = [os.path.join(tmpdir, "kv-worker-%d.json" % i)
                  for i in range(4)]
    kv_rcs = []
    kv_errors = []

    def kv_done():
        recs = [_read_json(p) for p in kv_reports]
        return (sum(r.get("acked", 0) for r in recs),
                sum(r.get("failed", 0) for r in recs))

    def kv_launch(restart):
        acked, failed = kv_done()
        remaining = max(0, int(kv_pushes) - acked - failed)
        if remaining == 0:
            return 0
        plan_spec = KV_WORKER_PLAN if restart == 0 else {
            # the respawned incarnation keeps the link weather but not
            # the kill — a fresh seed so its fault stream is its own
            "seed": KV_WORKER_PLAN["seed"] + restart,
            "rules": [r for r in KV_WORKER_PLAN["rules"]
                      if r["kind"] != "sigkill"],
        }
        env = _worker_env(plan_spec)
        env.update({"MXNET_KVSTORE_ASYNC_DIR": kv_root,
                    "DMLC_WORKER_ID": "1", "DMLC_NUM_WORKER": "2"})
        report = kv_reports[min(restart, len(kv_reports) - 1)]
        proc = subprocess.run(
            [sys.executable, "-u", "-m", "mxnet_tpu_torch.fault.drill",
             "--kv-worker", "--pushes", str(remaining),
             "--report", report, "--ctx", _ctx_arg(ctx)],
            env=env, cwd=_REPO, capture_output=True, text=True,
            timeout=240)
        kv_rcs.append(proc.returncode)
        if proc.returncode > 0:
            raise AssertionError("kv worker failed deterministically "
                                 "rc=%s:\n%s" % (proc.returncode,
                                                 proc.stderr[-2000:]))
        return proc.returncode

    def kv_fleet():
        try:
            ProcessSupervisor(
                retries=len(kv_reports),
                backoff=BackoffPolicy(retries=0, base_s=0.01, max_s=0.02,
                                      jitter=0.0, seed=1)).run(kv_launch)
        except Exception as exc:   # re-raised on the main thread
            kv_errors.append(exc)

    # -- checkpoint writer/reader under IO weather ---------------------------
    mod = _soak_module(seed=0, ctx=ctx)
    mgr = CheckpointManager(directory=ckpt_dir, async_save=False,
                            keep_last=4)
    stop = threading.Event()
    commit_attempts = [0, 0]
    integrity_failures = []
    reader_polls = [0]

    def writer():
        i = 0
        while not stop.is_set():
            i += 1
            commit_attempts[0] += 1
            try:
                mgr.save_module(mod, epoch=i, block=True)
            except (OSError, CheckpointError):
                # injected commit/manifest weather (a manifest fault can
                # surface as CheckpointError via the post-save byte
                # count); the next period retries
                commit_attempts[1] += 1
            stop.wait(0.15)

    def reader():
        while not stop.is_set():
            steps_now = mgr.store.steps()
            if steps_now:
                reader_polls[0] += 1
                try:
                    mgr.store.read(steps_now[-1], verify=True)
                except IntegrityError as exc:
                    integrity_failures.append(str(exc))
                except (OSError, ValueError, CheckpointError):
                    pass   # injected transient weather (a manifest
                    # fault surfaces as CheckpointError, not OSError)
            stop.wait(0.05)

    # -- serving clients -----------------------------------------------------
    counts = {"submitted": 0, "served": 0, "typed_failures": 0}
    counts_lock = threading.Lock()

    def client(ci):
        """Every ``fd.infer`` call terminates in exactly one outcome —
        a result or a typed error (the front door's sliced wait bounds
        it); a hang would show up as submitted > served + typed."""
        crng = np.random.RandomState(300 + ci)
        while not stop.is_set():
            rows = 1 + int(crng.randint(0, 4))
            with counts_lock:
                counts["submitted"] += 1
            try:
                outs = fd.infer(
                    "m", crng.randn(rows, 6).astype(np.float32))
                assert outs[0].shape[0] == rows
                with counts_lock:
                    counts["served"] += 1
            except ServingError:
                with counts_lock:
                    counts["typed_failures"] += 1

    # warm OUTSIDE the plan window: replica subprocesses take seconds
    # to import; the soak's traced weather starts once they answer
    warm = np.zeros((1, 6), np.float32)
    ready = 0
    deadline = time.monotonic() + 180
    while ready < replicas and time.monotonic() < deadline:
        try:
            fd.infer("m", warm)
            ready += 1
        except ServingError:
            time.sleep(0.2)
    assert ready >= replicas, \
        "replica fleet never came up: %r" % (fd.replica_status(),)

    threads = [threading.Thread(target=writer, daemon=True),
               threading.Thread(target=reader, daemon=True)]
    threads += [threading.Thread(target=client, args=(ci,), daemon=True)
                for ci in range(clients)]
    kv_thread = threading.Thread(target=kv_fleet, daemon=True)

    t0 = time.monotonic()
    killed_rid = None
    try:
        with fault.active_plan(plan):
            for t in threads:
                t.start()
            kv_thread.start()
            # a third in: SIGKILL one serving replica — the host-death
            # move; its in-flight requests must resubmit, not vanish
            time.sleep(duration_s / 3.0)
            victim = handles[-1]
            killed_rid = victim.rid
            victim.kill()
            time.sleep(duration_s - duration_s / 3.0)
            # the ≥ min_faults bar self-extends (bounded): fault volume
            # is traffic-dependent, the bar is not
            hard_stop = t0 + max(duration_s * 6, 60.0)
            while len(plan.stats()["injected"]) < min_faults \
                    and time.monotonic() < hard_stop:
                time.sleep(1.0)
            stop.set()
            for t in threads:
                t.join(timeout=60)
            kv_thread.join(timeout=240)
            # drain: the last grads may still be crossing the seam
            # (resends waiting in the spool count too — the server
            # thread scans, dedups, and drops them)
            assert kv.wait_to_drain(timeout=60), "push spool never drained"
            settle = time.monotonic() + 15
            while kv._transport.stats()["received"] \
                    > len(kv._applied_log) \
                    and time.monotonic() < settle:
                time.sleep(0.02)
    finally:
        stop.set()
    wall = time.monotonic() - t0
    if kv_errors:
        raise kv_errors[0]
    fd_stats = fd.stats()
    fd.close()

    # -- invariants ----------------------------------------------------------
    # (1) serving exactly-once: every call resolved, fleet ledger
    # conserved, late duplicates dropped not delivered
    resolved = counts["served"] + counts["typed_failures"]
    assert resolved == counts["submitted"], \
        "lost requests: %d submitted, %d resolved" % (
            counts["submitted"], resolved)
    assert counts["served"] > 0, "fleet served nothing"
    led = {k: fd_stats[k] for k in ("submitted", "served", "failed",
                                    "expired", "resubmitted", "retried",
                                    "duplicates_dropped", "ejections",
                                    "readmissions")}
    assert led["submitted"] == led["served"] + led["failed"] \
        + led["expired"], "fleet ledger unbalanced: %s" % led
    assert led["ejections"] >= 1, \
        "the killed replica was never ejected: %s" % (
            fd_stats["replicas"],)
    # (2) training exactly-once: acked <= applied (a recorded ack WAS
    # delivered) <= acked + failed (an exhausted push may still have
    # landed once — never twice: dedup absorbs every resend)
    acked, failed_pushes = kv_done()
    applied = kv._transport.stats()["received"]
    assert acked <= applied <= acked + failed_pushes, \
        "gradient conservation violated: acked=%d applied=%d failed=%d" \
        % (acked, applied, failed_pushes)
    ids = [pf for _k, pf in kv._applied_log]
    assert len(ids) == len(set(ids)), "a gradient applied twice"
    got = nd.zeros((4,), ctx=ctx)
    kv.pull("w", out=got)
    assert np.allclose(got.asnumpy(), -0.1 * applied), \
        "weight drift: %r after %d applies" % (got.asnumpy(), applied)
    assert any(rc == -signal.SIGKILL for rc in kv_rcs), \
        "the kv worker was never killed: rcs=%r" % (kv_rcs,)
    assert kv_rcs[-1] == 0, "kv fleet never completed: %r" % (kv_rcs,)
    # (3) checkpoints: no reader ever resolved an incomplete one
    assert not integrity_failures, \
        "INCOMPLETE checkpoint visible to a reader: %s" % \
        integrity_failures[:3]
    # (4) fault volume + coverage (main plan + the kv worker's own)
    injected = plan.stats()["injected"]
    by_kind = {}
    for i in injected:
        by_kind[i["kind"]] = by_kind.get(i["kind"], 0) + 1
    kv_recs = [_read_json(p) for p in kv_reports]
    for rec in kv_recs:
        for k, v in (rec.get("by_kind") or {}).items():
            by_kind[k] = by_kind.get(k, 0) + v
    # the kv worker's injected sigkill cannot appear in its own report
    # (the process dies AT the injection); its observable effect — the
    # -SIGKILL exit the supervisor recovered from — is the count
    by_kind["sigkill"] = by_kind.get("sigkill", 0) + sum(
        1 for rc in kv_rcs if rc == -signal.SIGKILL)
    total = sum(by_kind.values())
    for kind in ("partition", "slow_link", "lost_ack", "reorder"):
        assert by_kind.get(kind, 0) > 0, \
            "network kind %r never injected: %s" % (kind, by_kind)
    assert by_kind.get("sigkill", 0) >= 1, by_kind
    assert total >= min_faults, \
        "only %d faults injected (< %d): %s" % (total, min_faults,
                                                by_kind)
    # (5) determinism witness: same plan + seed + hit sequence =>
    # identical fault timeline, in-process and in the drilled child
    assert plan.replay() == injected, \
        "replayed fault timeline diverged from the live one"
    finals = [r for r in kv_recs if r.get("final")]
    assert finals and all(r.get("replay_identical") for r in finals), \
        "kv worker replay witness failed: %r" % (kv_recs,)

    kv.close()
    report = {
        "duration_s": round(wall, 2),
        "serving": {
            "replicas": replicas,
            "replica_killed": killed_rid,
            "requests": dict(counts),
            "req_per_sec": round(counts["served"] / wall, 2),
            "fleet_ledger": led,
            "replica_status": {str(r): list(v) for r, v in
                               fd_stats["replicas"].items()},
            "transport": fd_stats["transport"],
        },
        "training": {
            "pushes_target": kv_pushes,
            "acked": acked,
            "push_failures": failed_pushes,
            "applied": applied,
            "worker_exits": kv_rcs,
            "worker_sigkilled": True,
            "coordinator_duplicates_dropped":
                kv._transport.stats()["duplicates_dropped"],
        },
        "checkpoints": {
            "commit_attempts": commit_attempts[0],
            "commit_failures_injected": commit_attempts[1],
            "complete_on_disk": len(mgr.store.steps()),
            "reader_polls": reader_polls[0],
            "integrity_failures": len(integrity_failures),
        },
        "faults_injected": {
            "total": total,
            "main_process": len(injected),
            "kv_worker": total - len(injected),
            "by_kind": by_kind,
            "host_kills": {"serving_replica": 1, "kv_worker": sum(
                1 for rc in kv_rcs if rc == -signal.SIGKILL)},
        },
        "zero_lost_requests": True,
        "zero_duplicated_requests": True,
        "zero_incomplete_checkpoint_reads": True,
        "gradients_applied_exactly_once": True,
        "replay_identical": True,
    }
    if own:
        import shutil
        shutil.rmtree(tmpdir, ignore_errors=True)
    return report


# ---------------------------------------------------------------------------
# CLI: worker modes (drill subprocesses) and the record
# ---------------------------------------------------------------------------

def _main(argv):
    import argparse
    ap = argparse.ArgumentParser(prog="mxnet_tpu_torch.fault.drill")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--kv-worker", action="store_true")
    ap.add_argument("--fused-parity-worker", action="store_true")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--pushes", type=int, default=30)
    ap.add_argument("--report", default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--loss-log", default=None)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--init", default=None)
    ap.add_argument("--ctx", choices=("gpu", "cpu"), default="gpu")
    ap.add_argument("--record", default=None,
                    help="run the drills and soaks, write this JSON record")
    args = ap.parse_args(argv)
    if args.worker:
        worker_main(args.world, args.steps, args.ckpt, args.loss_log,
                    rank=args.rank, init_method=args.init,
                    device_type=args.ctx)
        return 0
    if args.kv_worker:
        from ..context import Context
        kv_worker_main(args.pushes, args.report, ctx=Context(args.ctx))
        return 0
    if args.fused_parity_worker:
        return fused_parity_worker_main(args.report, rank=args.rank,
                                        world=args.world,
                                        init_method=args.init,
                                        device_type=args.ctx)
    from ..context import Context
    ctx = Context(args.ctx)
    # same-width kill/restart must be EXACT; shrink-then-grow matches to
    # float32 reduction noise of the re-associated gradient sums
    same_width = elastic_kill_drill(widths=(4, 4, 4), ctx=ctx)
    reshard = elastic_kill_drill(widths=(4, 2, 8), atol=1e-5, ctx=ctx)
    soak = fleet_network_soak(ctx=ctx)
    fused_parity = fused_sweep_parity_drill(ctx=ctx)
    record = {"elastic_kill_drill_same_width": same_width,
              "elastic_kill_drill_reshard": reshard,
              "fleet_network_soak": soak,
              "fused_sweep_parity": fused_parity}
    out = args.record or "drill_record.json"
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print("wrote", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(_main(sys.argv[1:]))
