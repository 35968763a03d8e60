"""The port's Trainer against the JAX Trainer, on the CPU.

The setup is ``tests/test_e2e.py``'s tiny config (8x56 images, 8-wide
stages, one 8-wide block a head tower) in fp32, on a synthetic corpus of
one train and one val log of two sweeps (the port's ``generate_dataset``,
equal to the JAX one's, ``test_torch_data.py``), debug learning rate (a
constant 1e-3), no augmentations, ``trainer.devices=1``. Both Trainers
start from the same state: the JAX Trainer's own ``_init_state``,
transplanted into a port ``TrainState``.

Held:

- three epochs of one step: each step's loss within 1e-4 relative, and
  in the first two steps every metric of ``detection_loss`` too (PR 8's
  gate for the train step; seen: 1.4e-6) and ``grad_norm`` within 1e-3
  (PR 8's gradient gate, this model's fp32 gradients being
  ill-conditioned, ``test_torch_train_step.py``; seen: 9.9e-4). The third
  step is taken at parameters that differ by AdamW's sign flips: at the
  constant debug rate an element whose gradient lies within the noise of
  0 moves by about 1e-3 either way in the first update. There the loss
  stays within 1e-4 (seen: 5.5e-5), its components within 1e-3 (seen:
  2.1e-4) and ``grad_norm`` within 5e-2 (seen: 1.5e-2);
- the parameters after ``fit`` within 1e-5 of each leaf's max plus the
  AdamW sign-flip bound of twice the summed learning rates (PR 8's);
- the JAX Trainer's shards scored by the port's evaluator equal the JAX
  evaluator's numbers exactly;
- the port's own shards: the same kept count per sweep, and the AV2
  metrics within 1e-3 absolute of the JAX shards' (a box within 1e-4 m of
  its JAX twin moves a center distance by about that, far inside the
  0.5 m affinity threshold; sizes and yaw move ASE and AOE by about as
  much);
- resume: a second Trainer on the run directory continues the step count
  from the last checkpoint;
- ``trainer.devices=2`` in a process that is not a rank of a 2-rank
  group raises; ``trainer.zero1=true`` at world size 1 trains the
  replicated run's parameters bit for bit (both cases of
  ``test_multi_device_options_raise``, whose name is kept); a CUDA device
  on a host without one raises;
- the PNGs written every ``train_log_freq`` steps decode.

``python tests/test_torch_trainer.py overfit av2 EPOCHS WORK_DIR`` runs
the JAX package's debug overfit (``scripts/debug-overfit.sh``'s corpus
and overrides, in-process on the CPU) and prints each step's loss and the
mAP: the source of ``chip_smoke.py`` phase 18's gate.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from range_view_3d_detection_torch import transplant
from range_view_3d_detection_torch.data.synthetic import generate_dataset
from range_view_3d_detection_torch.evaluation import av2_eval as tav2
from range_view_3d_detection_torch.training import loop as tloop
from range_view_3d_detection_torch.training import state as tstate
from range_view_3d_detection_torch.utils import config as tconfig
from range_view_3d_detection_torch.utils.rendering import read_png

REPO = Path(__file__).resolve().parent.parent
LR = 1e-3
STEPS = 3


def tiny_overrides(root, run_dir, **extra):
    ov = {
        "dataset.root_dir": root,
        "dataset._train_dataset.range_view_config.height": 8,
        "dataset._train_dataset.range_view_config.width": 56,
        "model.max_boxes": 16,
        "model._backbone.layers": "[8,8,8,8,8]",
        "model._head.fpn": "{1: 16}",
        "model._head.classification_head_channels": 8,
        "model._head.regression_head_channels": 8,
        "model._head.num_classification_blocks": 1,
        "model._head.num_regression_blocks": 1,
        "model.post_processing_config.nms_cap": 128,
        "model.post_processing_config.min_confidence": 0.01,
        "model.precision": "float32",
        "model.augmentations_config": "null",
        "model.train_log_freq": 0,
        "model._scheduler.max_lr": LR,
        "trainer.max_epochs": STEPS,
        "trainer.devices": 1,
        "run_dir": run_dir,
        **extra,
    }
    return [f"++{k}={v}" for k, v in ov.items()]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer") / "sensor"
    generate_dataset(root, splits={"train": 1, "val": 1}, sweeps_per_log=2, height=8,
                     width=56, num_boxes=4, num_bg_points=800, seed=1)
    return root


def record(trainer, sink):
    step = trainer.train_step

    def recording(state, batch):
        state, metrics = step(state, batch)
        sink.append({k: float(v) for k, v in metrics.items()})
        return state, metrics

    trainer.train_step = recording


@pytest.fixture(scope="module")
def both(corpus, tmp_path_factory):
    from range_view_3d_detection_tpu.data.dataset import collate
    from range_view_3d_detection_tpu.training.loop import Trainer as JTrainer
    from range_view_3d_detection_tpu.utils.config import compose as jcompose

    out = tmp_path_factory.mktemp("runs")
    jcfg = jcompose(REPO / "conf", "rv-synthetic", tiny_overrides(corpus, out / "jax"))
    tcfg = tconfig.compose(REPO / "conf", "rv-synthetic", tiny_overrides(corpus, out / "port"))
    assert json.dumps(jcfg, sort_keys=True) == json.dumps(
        {**tcfg, "run_dir": str(out / "jax")}, sort_keys=True
    ).replace(str(out / "port"), str(out / "jax"))
    jt, tt = JTrainer(jcfg), tloop.Trainer(tcfg, device="cpu")
    sample = collate([jt.train_ds[0], jt.train_ds[1]])
    jt.state = jt._init_state({k: v for k, v in sample.items() if k != "uuids"})
    st = tstate.create_state(tt.det_cfg, tt.tx, device="cpu")
    transplant.load_flax_variables(st.model, jt.state.params, jt.state.batch_stats)
    tt.state = st
    init = {k: np.asarray(v) for k, v in transplant.state_dict_to_flax(
        st.model.state_dict())[0].items()}
    jm, tm = [], []
    record(jt, jm)
    record(tt, tm)
    jt.fit()
    tt.fit()
    return dict(jt=jt, tt=tt, jm=jm, tm=tm, init=init,
                jdir=jt.validate(), tdir=tt.validate(), corpus=corpus)


def test_steps_match_jax(both):
    jm, tm = both["jm"], both["tm"]
    assert len(jm) == len(tm) == STEPS
    for i, (j, t) in enumerate(zip(jm, tm)):
        assert sorted(j) == sorted(t)
        for k in j:
            if k == "grad_norm":
                rtol = 1e-3 if i < 2 else 5e-2
            else:
                rtol = 1e-4 if i < 2 or k == "loss" else 1e-3
            np.testing.assert_allclose(t[k], j[k], rtol=rtol, atol=1e-7, err_msg=(i, k))
    assert both["tt"].state.step == int(both["jt"].state.step) == STEPS


def test_parameters_after_fit_match_jax(both):
    params, _ = transplant.state_dict_to_flax(both["tt"].state.model.state_dict())
    bound = 2.0 * LR * STEPS
    import jax

    got = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
           jax.tree_util.tree_leaves_with_path(params)}
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(both["jt"].state.params)}
    assert sorted(got) == sorted(want)
    for k in want:
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= 1e-5 * float(np.abs(want[k]).max()) + bound, (k, err)


def _score(module, pred_dir, corpus, categories):
    return module.evaluate_predictions(pred_dir, corpus / "val", categories=categories)


def test_port_evaluator_scores_jax_shards_exactly(both):
    from range_view_3d_detection_tpu.evaluation import av2_eval as jav2

    cats = both["jt"].categories
    want = _score(jav2, both["jdir"], both["corpus"], cats)
    got = _score(tav2, both["jdir"], both["corpus"], cats)
    assert got == want
    assert np.isfinite(got["AVERAGE_METRICS"]["AP"])


def test_port_shards_score_like_jax(both):
    from range_view_3d_detection_tpu.utils.feather import read_feather as jread

    jfiles = sorted(p.name for p in both["jdir"].glob("*.feather"))
    assert jfiles == sorted(p.name for p in both["tdir"].glob("*.feather"))
    assert len(jfiles) == 2
    for name in jfiles:
        j, t = jread(both["jdir"] / name), jread(both["tdir"] / name)
        assert sorted(j) == sorted(t) and len(j["score"]) == len(t["score"]) > 0
        assert list(j["category"]) == list(t["category"])
    cats = both["jt"].categories
    want = _score(tav2, both["jdir"], both["corpus"], cats)
    got = _score(tav2, both["tdir"], both["corpus"], cats)
    assert sorted(got) == sorted(want)
    for cat in want:
        for k, v in want[cat].items():
            assert abs(got[cat][k] - v) <= 1e-3, (cat, k, got[cat][k], v)


def test_resume_continues_the_step_count(corpus, tmp_path):
    run = tmp_path / "run"
    ov = tiny_overrides(corpus, run, **{"model.debug": "false", "trainer.max_epochs": 2,
                                        "model.train_log_freq": 1})
    cfg = tconfig.compose(REPO / "conf", "rv-synthetic", ov)
    first = tloop.Trainer(cfg, device="cpu")
    first.fit()
    assert first.state.step == 2 and first.ckpt.latest_step() == 2
    second = tloop.Trainer(cfg, device="cpu")
    second.fit()
    assert second.state.step == 4 and second.ckpt.steps() == [3, 4]
    restored, saved_cfg = second.ckpt.restore(
        tstate.create_state(second.det_cfg, second.tx, device="cpu"))
    assert restored.step == 4 and saved_cfg == json.loads(json.dumps(cfg))
    for a, b in zip(restored.model.state_dict().values(),
                    second.state.model.state_dict().values()):
        assert torch.equal(a, b)
    lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    # Losses are logged at step 1 and every 10th; the resumed run's steps
    # are 3 and 4.
    assert [x["step"] for x in lines if "loss" in x] == [1]
    # train_log_freq=1: a BEV and a range-panel PNG each step, decodable.
    for kind in ("bev", "range"):
        pngs = sorted((run / "images").glob(f"{kind}_*.png"))
        assert [p.name for p in pngs] == [f"{kind}_{s:07d}.png" for s in (1, 2, 3, 4)]
        for p in pngs:
            img = read_png(p)
            assert img.ndim == 3 and img.shape[2] == 3 and img.size > 0


@pytest.mark.parametrize("override,what", [
    ("++trainer.devices=2", "trainer.devices"),
    ("++trainer.zero1=true", "zero1"),
])
def test_multi_device_options_raise(corpus, tmp_path, override, what):
    cfg = tconfig.compose(REPO / "conf", "rv-synthetic",
                          tiny_overrides(corpus, tmp_path / "run") + [override])
    if what == "trainer.devices":
        with pytest.raises(ValueError, match=what):
            tloop.Trainer(cfg, device="cpu")
        return
    # zero1 without a process group: the replicated optimizer, same numbers.
    plain = tloop.Trainer(tconfig.compose(REPO / "conf", "rv-synthetic",
                                          tiny_overrides(corpus, tmp_path / "plain")),
                          device="cpu")
    zero1 = tloop.Trainer(cfg, device="cpu")
    assert zero1.zero1 and zero1.world == 1
    for t in (plain, zero1):
        t.fit()
    assert zero1.state.opt.owners is None
    for k, v in plain.state.model.state_dict().items():
        assert torch.equal(zero1.state.model.state_dict()[k], v), k


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a host without a card")
def test_default_device_raises_without_a_card(corpus, tmp_path):
    cfg = tconfig.compose(REPO / "conf", "rv-synthetic", tiny_overrides(corpus, tmp_path / "r"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.Trainer(cfg)


# -- the JAX debug overfit (not a test) ---------------------------------------


def jax_overfit(dataset: str, epochs: int, work_dir: Path) -> dict:
    """The JAX package's debug overfit of ``dataset`` in-process on the
    CPU, with the port's ``overfit.CORPORA`` spec (the scripts' corpus
    and overrides): each step's loss and the scripts' metrics."""
    from range_view_3d_detection_torch import overfit
    from range_view_3d_detection_tpu.data.synthetic import generate_dataset as jgen
    from range_view_3d_detection_tpu.training.loop import Trainer as JTrainer
    from range_view_3d_detection_tpu.utils.config import compose as jcompose

    spec = overfit.CORPORA[dataset]
    root = jgen(work_dir / "sensor", **spec["corpus"])
    cfg = jcompose(REPO / "conf", spec["experiment"], spec["overrides"] + [
        f"++dataset.root_dir={root}", f"++run_dir={work_dir / 'run'}",
        f"++trainer.max_epochs={epochs}", "++trainer.devices=1",
    ])
    trainer = JTrainer(cfg)
    losses = []
    record(trainer, losses)
    trainer.fit()
    pred_dir = trainer.validate()
    from range_view_3d_detection_tpu.evaluation.av2_eval import evaluate_predictions

    split = Path(root) / "train"
    if dataset == "waymo":
        from range_view_3d_detection_tpu.evaluation.waymo_eval import evaluate_waymo, mean_ap
        from range_view_3d_detection_tpu.evaluation.av2_eval import (
            _join_valid_uuids, dedupe_predictions, load_ground_truth, load_predictions)

        dts, gts = _join_valid_uuids(dedupe_predictions(load_predictions(pred_dir)),
                                     load_ground_truth(split))
        cats = sorted(np.unique(gts["category"]).tolist())
        m = {tag: mean_ap(evaluate_waymo(dts, gts, cats, **kw), level=2)
             for tag, kw in (("penalty", {}), ("no_penalty", {"max_recall_delta": None}))}
    else:
        m = {"mAP": evaluate_predictions(pred_dir, split, categories=trainer.categories)[
            "AVERAGE_METRICS"]["AP"]}
    return {"losses": [x["loss"] for x in losses], **m}


if __name__ == "__main__":
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    _, dataset, epochs, work = sys.argv[1:5]
    res = jax_overfit(dataset, int(epochs), Path(work))
    loss = res.pop("losses")
    print(json.dumps({"steps": len(loss), "first_loss": loss[0],
                      "last10_mean_loss": float(np.mean(loss[-10:])),
                      "losses": loss, **res}))
