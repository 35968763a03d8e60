"""Driver entry points of the port (counterpart of the repo-root
``__graft_entry__.py``): the flagship forward on the card, and a dry run of
the multi-device paths over ``n`` ranks.

    python -m range_view_3d_detection_torch.dryrun            # entry() on the card
    python -m range_view_3d_detection_torch.dryrun N [--device cpu]

``dryrun_multichip(n)`` runs four phases, each as ``n`` spawned rank
processes that meet at ``tcp://localhost:<free port>`` (NCCL on
``cuda:<rank>``, gloo on the CPU):

1. the tiny train step, data-parallel, with ZeRO-1 optimizer moments;
2. the flagship's channel widths (reduced depth and extent unless
   ``RV3D_DRYRUN_FULL=1``): train step, eval step (K1 and K2 on a card) and
   a checkpoint saved and restored;
3. one width-sharded train step (``parallel/spatial.py``) of the tiny
   config on the JAX dry run's ``(data, model) = (n/4, 4)`` mesh
   (``mesh.make_mesh``; ``num_model`` 2 where n is not a multiple of 4, 1
   at n = 1): ``num_data`` requests of 8 x 64 ``num_model``, each split
   over its row of ranks;
4. raw-points serving, the clouds split over the ranks.

The whole run is held to ``RV3D_DRYRUN_BUDGET_S`` (default 420 s): a phase
that starts with under 20 s left is skipped, and one that times out is
reported SKIP-TIMEOUT when the budget ran out and FAIL-HANG when it did not.
A failed phase raises. Each phase function takes optional initial weights
(a state dict), so a test can carry another package's across.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import socket
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from range_view_3d_detection_torch import serving
from range_view_3d_detection_torch.parallel import mesh

DRYRUN_PHASES = (
    "_phase1_tiny_train",
    "_phase2_flagship_shapes",
    "_phase3_width_sharded",
    "_phase4_points_serving",
)


def entry(device: str | torch.device = "cuda"):
    """``(model, (feats, cart, mask))``: the flagship ``Detector`` in eval
    mode with seeded weights, and its B=1 64x1808 example inputs, on
    ``device``."""
    from range_view_3d_detection_torch.models.detector import Detector
    from range_view_3d_detection_torch.training.loop import resolve_device

    device = resolve_device(device)
    model = Detector(serving._flagship_config(), device=device,
                     generator=torch.Generator().manual_seed(0)).eval()
    inputs = tuple(torch.as_tensor(a, device=device)
                   for a in serving._sample_inputs(1, 64, 1808, 5))
    return model, inputs


def _rows(batch: dict, n: int) -> dict:
    """This rank's rows of a global batch of ``n`` x k rows."""
    r, k = mesh.rank(), len(batch["features"]) // n
    return {key: v[r * k:(r + 1) * k] for key, v in batch.items()}


def _state(cfg, tx, weights, device):
    from range_view_3d_detection_torch.training.state import create_state

    st = create_state(cfg, tx, device=device, generator=torch.Generator().manual_seed(0))
    if weights is not None:
        st.model.load_state_dict(weights, strict=True)
    return st


def _phase1_tiny_train(n: int, *, weights=None, device="cpu", work=None) -> float:
    """Tiny train step over the ranks (the global batch of n rows, one a
    rank), with ZeRO-1 moments; returns the global loss."""
    from range_view_3d_detection_torch.training import optim
    from range_view_3d_detection_torch.training.state import make_train_step

    cfg = serving._flagship_config(tiny=True)
    batch = _rows(serving._dryrun_batch(cfg, n, 8, 64, 5), n)
    tx, _ = optim.make_optimizer(1e-3, 10, debug=True, zero1=True)
    st = _state(cfg, tx, weights, device)
    _, metrics = make_train_step(cfg)(st, batch)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"phase 1: non-finite loss {loss}")
    return loss


def _phase2_flagship_shapes(n: int, *, weights=None, device="cpu", work=None) -> dict:
    """Flagship channel widths: a train step, an eval step (the K1 stem and
    K2 on a card) and a checkpoint round trip: rank 0 writes it into
    ``work`` (a directory every rank sees), every rank restores it."""
    from range_view_3d_detection_torch.models.decoder import DecoderConfig
    from range_view_3d_detection_torch.training import optim
    from range_view_3d_detection_torch.training.checkpoints import CheckpointManager
    from range_view_3d_detection_torch.training.state import make_eval_step, make_train_step

    full = os.environ.get("RV3D_DRYRUN_FULL", "") == "1"
    cfg = dataclasses.replace(serving._flagship_config(), max_boxes=32)
    if not full:
        cfg = dataclasses.replace(cfg, num_classification_blocks=1, num_regression_blocks=1,
                                  stage_blocks=(1, 1, 1, 1, 1))
    B, H, W = (n, 8, 448) if full else (n, 2, 64)
    batch = _rows(serving._dryrun_batch(cfg, B, H, W, 5, seed=2), n)
    tx, _ = optim.make_optimizer(1e-3, 10, debug=True)
    st = _state(cfg, tx, weights, device)
    st, metrics = make_train_step(cfg)(st, batch)
    loss = float(metrics["loss"])
    result = make_eval_step(cfg, DecoderConfig(nms_cap=256, num_post_nms=64))(st, batch)
    keep = mesh.all_sum(result.keep.sum().to(torch.float32))
    mgr = CheckpointManager(Path(work or tempfile.mkdtemp()) / "phase2_checkpoints")
    mgr.save(1, st, {"dryrun": True})
    restored, _ = mgr.restore(_state(cfg, tx, None, device))
    for name, value in st.model.state_dict().items():
        if not torch.equal(restored.model.state_dict()[name], value):
            raise RuntimeError(f"phase 2: checkpoint round trip changed {name}")
    if not np.isfinite(loss):
        raise RuntimeError(f"phase 2: non-finite loss {loss}")
    return {"loss": loss, "eval_keep": int(keep), "shape": [B, H, W]}


def mesh_layout(n: int) -> tuple:
    """Phase 3's ``(num_data, num_model)`` at ``n`` ranks: the JAX dry
    run's (``num_model = 4 if n % 4 == 0 else 2``), and (1, 1) at one."""
    num_model = 1 if n == 1 else 4 if n % 4 == 0 else 2
    return max(1, n // num_model), num_model


def _phase3_width_sharded(n: int, *, weights=None, device="cpu", work=None) -> float:
    """One width-sharded train step (loss and gradients) of the tiny config
    on the ``(data, model)`` mesh of :func:`mesh_layout`: ``num_data``
    requests of 8 x 64 ``num_model``, request d split over row d's ranks;
    BatchNorm moments over the whole mesh, the loss's normalizers over
    the data axis, the gradients summed over the mesh. Returns the global
    batch's loss (nan on a rank outside the mesh)."""
    from range_view_3d_detection_torch.models.detector import Detector, detection_loss
    from range_view_3d_detection_torch.parallel import spatial
    from range_view_3d_detection_torch.training.state import batch_to_device

    num_data, num_model = mesh_layout(n)
    m = mesh.make_mesh(num_data, num_model)
    if m.data_index < 0:
        return float("nan")
    cfg = serving._flagship_config(tiny=True)
    batch = serving._dryrun_batch(cfg, num_data, 8, 64 * num_model, 5, seed=3)
    d = m.data_index
    batch = batch_to_device({k: v[d:d + 1] for k, v in batch.items()}, device)
    model = Detector(cfg, device=device, generator=torch.Generator().manual_seed(0))
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    local = [spatial.shard_width(batch[k], m.width) for k in ("features", "cart", "mask")]
    out = spatial.gather_width(spatial.width_sharded_apply(model, m, train=True)(*local),
                               m.width)
    with mesh.replicated_batch(m.data):
        loss, _ = detection_loss(out, batch, cfg)
        total = mesh.all_sum(loss.detach())
    grads = mesh.all_reduce_grads(
        [g.contiguous() for g in torch.autograd.grad(loss, list(model.parameters()))],
        m.group)
    gnorm = float(sum(float((g.float() * g.float()).sum()) for g in grads))
    if not (np.isfinite(gnorm) and gnorm > 0.0):
        raise RuntimeError(f"phase 3: gradient norm {gnorm}")
    return float(total)


def _phase4_points_serving(n: int, *, weights=None, device="cpu", work=None) -> int:
    """Raw points to detections, the n clouds split over the ranks;
    returns the detections kept over all ranks."""
    from range_view_3d_detection_torch import export
    from range_view_3d_detection_torch.models.decoder import DecoderConfig

    cfg = serving._flagship_config(tiny=True)
    H, W_sensor, N = 8, 60, 512
    rng = np.random.default_rng(4)
    r = rng.uniform(5, 60, (n, N)).astype(np.float32)
    az = rng.uniform(-np.pi, np.pi, (n, N)).astype(np.float32)
    el = rng.uniform(-0.3, 0.1, (n, N)).astype(np.float32)
    xyz = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el)], axis=-1)
    laser = rng.integers(0, H, (n, N)).astype(np.int32)
    inten = rng.uniform(0, 1, (n, N)).astype(np.float32)
    predictor = serving.Predictor(cfg, DecoderConfig(nms_cap=128, num_post_nms=32),
                                  device=device, generator=torch.Generator().manual_seed(0))
    if weights is not None:
        predictor.model.load_state_dict(weights, strict=True)
    points, _ = export.make_points_predict(
        predictor, sensor_width=W_sensor, height=H,
        feature_names=("intensity", "range", "x", "y", "z"))
    k = mesh.rank()
    result = points(xyz[k:k + 1], laser[k:k + 1], inten[k:k + 1])
    if not bool(torch.isfinite(result.cuboids).all()):
        raise RuntimeError("phase 4: non-finite cuboids")
    return int(mesh.all_sum(result.keep.sum().to(torch.float32)))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn_name: str, rank: int, world: int, init_method: str, device_type: str,
               weights_path: str | None, work: str, q) -> None:
    """A rank process (module level, so the ``spawn`` context can pickle
    it): join the group, run one phase, put ``(rank, status, payload)``."""
    try:
        os.environ["LOCAL_RANK"] = str(rank)
        if device_type == "cpu":
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
            torch.set_num_threads(1)
        device = mesh.initialize_distributed(device_type, init_method=init_method,
                                             rank=rank, world_size=world)
        weights = torch.load(weights_path, weights_only=True) if weights_path else None
        result = globals()[fn_name](world, weights=weights, device=device, work=Path(work))
        q.put((rank, "ok", result))
    except BaseException as e:  # report, don't hang the parent
        q.put((rank, "err", f"{type(e).__name__}: {e}\n{traceback.format_exc()[-3000:]}"))
    finally:
        if mesh.active():
            torch.distributed.destroy_process_group()


def _run_phase(ctx, fn_name: str, n: int, device_type: str, weights_path, work: str,
               timeout: float):
    """Start the n ranks of one phase and wait for them up to ``timeout``
    seconds. Returns ``("ok", rank 0's result)``, ``("err", messages)`` or
    ``("timeout", None)``; every process is ended before it returns."""
    q = ctx.Queue()
    init = f"tcp://localhost:{_free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(fn_name, r, n, init, device_type, weights_path, work, q))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + timeout
    reports = {}
    try:
        while len(reports) < n and time.perf_counter() < deadline:
            try:
                rank, status, payload = q.get(timeout=1.0)
                reports[rank] = (status, payload)
                if status == "err":
                    break
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
        for p in procs:
            p.join(max(0.0, min(30.0, deadline - time.perf_counter())))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    errors = [payload for status, payload in reports.values() if status == "err"]
    errors += [f"rank {r} exit code {p.exitcode}" for r, p in enumerate(procs)
               if r not in reports and p.exitcode not in (None, 0, -15)]
    if errors:
        return "err", errors
    if len(reports) < n:
        return "timeout", None
    return "ok", reports[0][1]


def dryrun_multichip(n_devices: int, *, device: str = "cuda", weights=None) -> dict:
    """Run the four phases over ``n_devices`` ranks on ``device`` ("cuda":
    NCCL, one card a rank; "cpu": gloo). ``weights`` maps a phase function's
    name to its initial state dict. Returns ``{phase: {"status",
    "result"}}``; raises if a phase failed or hung."""
    import multiprocessing

    if device == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}): {torch.cuda.device_count()} CUDA device(s) "
            "on this host; pass device='cpu' for gloo ranks on the CPU")
    budget_s = float(os.environ.get("RV3D_DRYRUN_BUDGET_S", "420"))
    t0 = time.perf_counter()

    def say(msg: str) -> None:
        print(f"{msg} [t={time.perf_counter() - t0:.0f}s]", flush=True)

    def fmt2(p):
        return "loss={:.4f} eval_keep={} shape={}x{}x{}".format(
            p["loss"], p["eval_keep"], *p["shape"])

    phases = [
        ("phase1", f"tiny train, {n_devices}-way data, ZeRO-1", "_phase1_tiny_train",
         lambda r: f"loss={r:.4f}", budget_s),
        ("phase2", "flagship channel widths, train+eval+ckpt", "_phase2_flagship_shapes",
         fmt2, 0.65 * budget_s),
        ("phase3", "width-sharded train on a {}x{} (data, model) mesh".format(
            *mesh_layout(n_devices)), "_phase3_width_sharded",
         lambda r: f"loss={r:.4f}", budget_s),
        ("phase4", "data-sharded points->NMS serving", "_phase4_points_serving",
         lambda r: f"keep={r}", budget_s),
    ]
    ctx = multiprocessing.get_context("spawn")
    results, failures = {}, []
    with tempfile.TemporaryDirectory() as td:
        paths = {}
        for fn_name, sd in (weights or {}).items():
            paths[fn_name] = str(Path(td) / f"{fn_name}.pt")
            torch.save(sd, paths[fn_name])
        for name, desc, fn_name, fmt, cap_s in phases:
            left = min(budget_s - (time.perf_counter() - t0), cap_s)
            if left < 20.0:
                say(f"dryrun {name} SKIP (wall-clock budget {budget_s:.0f}s exhausted)")
                results[name] = {"status": "skip"}
                continue
            say(f"dryrun {name} ({desc}) starting, {left:.0f}s left...")
            status, payload = _run_phase(ctx, fn_name, n_devices, device,
                                         paths.get(fn_name), td, left)
            if status == "ok":
                say(f"dryrun {name} OK ({desc}): {fmt(payload)}")
                results[name] = {"status": "ok", "result": payload}
            elif status == "timeout":
                budget_left = budget_s - (time.perf_counter() - t0)
                if budget_left > 30.0:
                    say(f"dryrun {name} FAIL-HANG: hit its {left:.0f}s cap with "
                        f"{budget_left:.0f}s budget remaining ({desc})")
                    failures.append(name)
                    results[name] = {"status": "hang"}
                else:
                    say(f"dryrun {name} SKIP-TIMEOUT after {left:.0f}s ({desc})")
                    results[name] = {"status": "skip-timeout"}
            else:
                say(f"dryrun {name} FAIL ({desc}): " + "\n".join(payload))
                failures.append(name)
                results[name] = {"status": "fail", "errors": payload}
    if failures:
        raise RuntimeError(f"dryrun phases failed: {failures}")
    say(f"dryrun_multichip(n={n_devices}, {device}) ok")
    return results


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=0,
                    help="ranks for the multi-device dry run (0: entry() once)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.n:
        dryrun_multichip(args.n, device=args.device)
        return 0
    model, inputs = entry(args.device)
    with torch.inference_mode():
        out = model(*inputs)
    head = out["head"][1][0]
    print(f"entry ok: logits {tuple(head['logits'].shape)} on {inputs[0].device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
