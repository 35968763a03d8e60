"""Port parity for the raw-points front end and the small ops under it, CPU.

JAX: ``ops/projection.py`` (jitted, vmapped per cloud as
``tools/export.py::make_points_predict`` runs it), ``ops/index.py``,
``ops/sorting.py`` and ``ops/iou.py::_rotated_rect_intersection_area_sorted``.
Port: ``range_view_3d_detection_torch/ops/{projection,index,sorting,iou}.py``.

Held exactly (same inputs, equal outputs): the z-buffer's winners and
occupancy on clouds with many exact range ties and rows below the minimum
distance; every z-buffer form; ``(row, col, range)`` at 131,072 points of
``tools/export.py::_sample_points``; the rasterized ``(features, cart,
mask)``; the index and sorting functions. The sorted-polygon IoU within
1e-5 (fp32 rounding of the angle sort's ``atan2``).
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from range_view_3d_detection_torch.ops import index as tindex
from range_view_3d_detection_torch.ops import iou as tiou
from range_view_3d_detection_torch.ops import projection as tproj
from range_view_3d_detection_torch.ops.sorting import sort_with_payload
from range_view_3d_detection_tpu.data.dataset import (
    AV2_FEATURES,
    WAYMO_FEATURES,
    width_padding,
)
from range_view_3d_detection_tpu.ops import index as jindex
from range_view_3d_detection_tpu.ops import iou as jiou
from range_view_3d_detection_tpu.ops import projection as jproj
from range_view_3d_detection_tpu.ops import sorting as jsorting

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from export import _sample_points  # noqa: E402

torch.set_num_threads(2)


def _tied_cloud(n, H, W, seed):
    """Points on few pixels with ranges from a coarse grid (many exact
    ties), a quarter of them below ``MIN_DISTANCE``."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, H, n).astype(np.int32)
    col = rng.integers(0, W, n).astype(np.int32)
    dist = rng.choice(np.asarray([0.0, 0.5, 1.0, 2.0, 3.5], np.float32), n)
    return row, col, dist


def _j_winners(row, col, dist, H, W):
    fn = jax.jit(lambda r, c, d: jproj.z_buffer_winner_map(r, c, d, height=H, width=W))
    winner, has = fn(row, col, dist)
    return np.asarray(winner), np.asarray(has)


def test_winner_map_equals_jax_with_ties():
    H, W = 6, 10
    rows, cols, dists = zip(*(_tied_cloud(160, H, W, seed=s) for s in range(3)))
    for row, col, dist in zip(rows, cols, dists):
        want_w, want_h = _j_winners(row, col, dist, H, W)
        assert want_h.sum() > H * W // 2 and not want_h.all()
        # Pixels whose nearest range is held by two points or more.
        flat = (row * W + col)[dist >= 1.0]
        d = dist[dist >= 1.0]
        nearest = {f: d[flat == f].min() for f in np.unique(flat)}
        assert sum((d[flat == f] == m).sum() > 1 for f, m in nearest.items()) > 5
        got_w, got_h = tproj.z_buffer_winner_map(
            torch.from_numpy(row), torch.from_numpy(col), torch.from_numpy(dist),
            height=H, width=W,
        )
        np.testing.assert_array_equal(got_h.numpy(), want_h)
        np.testing.assert_array_equal(got_w.numpy(), want_w)  # everywhere
    # Batched: one sort for the three clouds, each cloud's winners.
    got_w, got_h = tproj.z_buffer_winner_map(
        *(torch.from_numpy(np.stack(a)) for a in (rows, cols, dists)), height=H, width=W
    )
    for b in range(3):
        want_w, want_h = _j_winners(rows[b], cols[b], dists[b], H, W)
        np.testing.assert_array_equal(got_h[b].numpy(), want_h)
        np.testing.assert_array_equal(got_w[b].numpy()[want_h], want_w[want_h])


def test_z_buffer_forms_agree():
    H, W = 6, 10
    row, col, dist = _tied_cloud(160, H, W, seed=7)
    values = np.random.default_rng(8).normal(size=(160, 3)).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda r, c, d, v: jproj.z_buffer_jax_sorted(r, c, d, v, height=H, width=W)
    )(row, col, dist, values))
    np.testing.assert_array_equal(
        np.asarray(jproj.z_buffer_jax(row, col, dist, values, height=H, width=W)), want
    )
    args = [torch.from_numpy(a) for a in (row, col, dist, values)]
    for fn in (tproj.z_buffer, tproj.z_buffer_sorted):
        np.testing.assert_array_equal(fn(*args, height=H, width=W).numpy(), want)
    # The host form breaks ties by its lexsort, so give it distinct ranges.
    dist = dist + np.arange(160, dtype=np.float32) * 1e-3
    host = tproj.z_buffer_numpy(
        row.astype(np.int64), col.astype(np.int64), dist, values, height=H, width=W
    )
    args[2] = torch.from_numpy(dist)
    np.testing.assert_array_equal(tproj.z_buffer_sorted(*args, height=H, width=W).numpy(),
                                  host)


@pytest.mark.parametrize("width", [1800, 2650])
def test_range_view_coordinates_bit_exact(width):
    xyz, laser, _ = _sample_points(1, 131072, 64, width, seed=0)
    xyz, laser = xyz[0], laser[0]
    want = jax.jit(
        lambda p, ln: jproj.range_view_coordinates_jax(p, ln, height=64, width=width)
    )(xyz, laser)
    got = tproj.range_view_coordinates_t(
        torch.from_numpy(xyz), torch.from_numpy(laser), height=64, width=width
    )
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


def _cloud_batch(B, n, H, W, names, seed, zero_rows=0):
    xyz, laser, inten = _sample_points(B, n, H, W, seed=seed)
    rng = np.random.default_rng(seed + 1)
    laser = rng.integers(0, H, size=(B, n)).astype(np.int32)
    extras = {"intensity": inten * 4.0}
    if "elongation" in names:
        extras["elongation"] = rng.uniform(0, 2, (B, n)).astype(np.float32)
    if "timedelta_ns" in names:
        extras["timedelta_ns"] = rng.uniform(0, 1e8, (B, n)).astype(np.float32)
    if zero_rows:
        xyz[:, -zero_rows:] = 0.0
        laser[:, -zero_rows:] = 0
    return xyz, laser, extras


CASES = {
    # name: (H, sensor W, feature names, dataset, x_stride, padding mode, zero rows)
    "av2_stride1": (8, 56, AV2_FEATURES, "av2", 1, "circular", 0),
    "waymo_view_stride2": (40, 60, WAYMO_FEATURES + ("view", "timedelta_ns"), "waymo", 2,
                           "circular", 0),
    "constant_padding": (8, 60, AV2_FEATURES, "av2", 1, "constant", 0),
    "zero_pad_rows": (8, 56, AV2_FEATURES, "av2", 1, "circular", 300),
    # rv-av2-fast's layout: AV2 padded by width_padding(232, 4) = 12 a
    # side, constant, every 4th column kept (256 / 4 = 64).
    "av2_stride4_constant": (8, 232, AV2_FEATURES, "av2", 4, "constant", 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rasterize_points_equals_jax(case):
    H, W, names, dataset, stride, mode, zero_rows = CASES[case]
    pad = width_padding(W, stride)
    xyz, laser, extras = _cloud_batch(2, 1500, H, W, names, seed=11, zero_rows=zero_rows)
    extra_names = [n for n in names if n not in ("range", "x", "y", "z", "view")]
    kw = dict(height=H, width=W, feature_names=tuple(names), dataset_name=dataset,
              x_stride=stride, pad=pad, padding_mode=mode)

    def one(p, ln, *ch):
        return jproj.rasterize_points_jax(p, ln, dict(zip(extra_names, ch)), **kw)

    want = jax.jit(jax.vmap(one))(xyz, laser, *(extras[n] for n in extra_names))
    got = tproj.rasterize_points(
        torch.from_numpy(xyz), torch.from_numpy(laser),
        {n: torch.from_numpy(extras[n]) for n in extra_names}, **kw,
    )
    Wp = (W + 2 * pad) // stride
    for g, w, shape in zip(got, want, [(2, H, Wp, len(names)), (2, H, Wp, 3), (2, H, Wp)]):
        assert g.shape == shape and g.numpy().dtype == np.asarray(w).dtype
    feats, want_feats = got[0].numpy(), np.asarray(want[0])
    if dataset == "waymo":
        # torch's tanh and XLA's CPU tanh are different approximations:
        # Waymo's intensity plane is held within 4 ulps, the rest exactly.
        i = names.index("intensity")
        np.testing.assert_array_max_ulp(feats[..., i], want_feats[..., i], maxulp=4)
        feats, want_feats = np.delete(feats, i, -1), np.delete(want_feats, i, -1)
    np.testing.assert_array_equal(feats, want_feats)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < got[2].sum() < got[2].numel()


def test_index_functions_equal_jax():
    rng = np.random.default_rng(0)
    shape = (3, 5, 7)
    multi = np.stack([rng.integers(0, s, 40) for s in shape], axis=-1).astype(np.int32)
    flat = np.asarray(jindex.ravel_multi_index(jnp.asarray(multi), shape))
    np.testing.assert_array_equal(
        tindex.ravel_multi_index(torch.from_numpy(multi), shape).numpy(), flat
    )
    np.testing.assert_array_equal(
        tindex.unravel_index(torch.from_numpy(flat.copy()), shape).numpy(),
        np.asarray(jindex.unravel_index(jnp.asarray(flat), shape)),
    )
    uniq = np.unique(flat, return_index=True)[1]
    idx, upd = multi[uniq], rng.normal(size=len(uniq)).astype(np.float32)
    np.testing.assert_array_equal(
        tindex.scatter_nd(torch.from_numpy(idx), torch.from_numpy(upd), shape).numpy(),
        np.asarray(jindex.scatter_nd(jnp.asarray(idx), jnp.asarray(upd), shape)),
    )
    np.testing.assert_array_equal(tindex.mgrid((2, 3, 4)).numpy(), jindex.mgrid((2, 3, 4)))
    centers = multi[:5]
    np.testing.assert_array_equal(
        tindex.ogrid_sparse_neighborhoods(torch.from_numpy(centers), (3, 3, 1)).numpy(),
        np.asarray(jindex.ogrid_sparse_neighborhoods(jnp.asarray(centers), (3, 3, 1))),
    )
    rows = rng.integers(0, 3, (30, 2))
    np.testing.assert_array_equal(
        tindex.unique_indices(torch.from_numpy(rows)).numpy(),
        np.asarray(jindex.unique_indices(rows)),
    )


@pytest.mark.parametrize("n,n_pad", [(24, None), (13, 32), (32, None)])
def test_sort_with_payload_equals_bitonic_network(n, n_pad):
    """Keys from three values (ties everywhere): the port's order equals
    the network's, which is not a stable sort's."""
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 3, (64, n)).astype(np.float32)
    payload = rng.normal(size=(64, n, 2)).astype(np.float32)
    want_k, want_p = jsorting.sort_with_payload(jnp.asarray(keys), jnp.asarray(payload),
                                                n_pad=n_pad)
    got_k, got_p = sort_with_payload(torch.from_numpy(keys), torch.from_numpy(payload),
                                     n_pad=n_pad)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    stable = np.take_along_axis(payload, np.argsort(keys, kind="stable")[..., None], 1)
    assert (got_p.numpy()[:, :n] != stable).any()


def test_sorted_iou_formulation_matches_jax():
    rng = np.random.default_rng(3)
    n = 300
    a = np.concatenate([rng.uniform(-3, 3, (n, 2)), rng.uniform(0.5, 5, (n, 2)),
                        rng.uniform(-np.pi, np.pi, (n, 1))], axis=-1).astype(np.float32)
    b = a.copy()
    b[:, :2] += rng.normal(size=(n, 2)).astype(np.float32)
    b[:, 4] += rng.normal(size=n).astype(np.float32) * 0.5
    b[:10] = a[:10]  # identical pairs
    want = np.asarray(jiou._rotated_rect_intersection_area_sorted(jnp.asarray(a),
                                                                  jnp.asarray(b)))
    got = tiou._rotated_rect_intersection_area_sorted(torch.from_numpy(a),
                                                      torch.from_numpy(b)).numpy()
    assert (want > 0).sum() > n // 2
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # It agrees with the order-free form the served path uses.
    np.testing.assert_allclose(
        got, tiou.rotated_rect_intersection_area(torch.from_numpy(a),
                                                 torch.from_numpy(b)).numpy(),
        atol=1e-3, rtol=1e-3,
    )


def study(n: int = 131072) -> None:
    """The forms behind ``ops/projection.py``'s choices, counted against
    jitted JAX on the CPU (``PYTHONPATH=. python
    tests/test_torch_projection.py``):
    azimuth columns and ranges of one ``_sample_points`` cloud in several
    torch forms, the key-sort winners on a cloud with heavy range ties,
    and how often the bitonic network orders ties otherwise than a stable
    sort."""
    import math

    jax.config.update("jax_platforms", "cpu")
    xyz, laser, _ = _sample_points(1, n, 64, 1800, seed=0)
    xyz, laser = xyz[0], laser[0]
    _, jcol, jrng = (np.asarray(a) for a in jax.jit(
        lambda p, ln: jproj.range_view_coordinates_jax(p, ln, height=64, width=1800)
    )(xyz, laser))
    t = torch.from_numpy(xyz)
    x, y, z = t.unbind(-1)
    az = torch.atan2(y, x)
    jaz = np.asarray(jax.jit(lambda p: jnp.arctan2(p[:, 1], p[:, 0]))(xyz))
    print(f"{n} points; atan2: {int((az.numpy() != jaz).sum())} differ from JAX")
    W = 1800
    cols = {
        "(az + pi) / (2 pi) * W": (az + math.pi) / (2 * math.pi) * W,
        "float32 constants": (az + np.float32(np.pi)) / np.float32(2 * np.pi) * np.float32(W),
        "(az + pi) * (1 / 2 pi) * W": (az + math.pi) * (1 / (2 * math.pi)) * W,
        "(az + pi) * float32(W / 2 pi)": (az + math.pi) * float(
            np.float32(W) / np.float32(2 * np.pi)),
    }
    for name, c in cols.items():
        bad = int(((c.to(torch.int32) % W).numpy() != jcol).sum())
        print(f"column {name}: {bad} differ from JAX")
    r2 = torch.addcmul(torch.addcmul(x * x, y, y), z, z)
    rngs = {
        "linalg.vector_norm": torch.linalg.vector_norm(t, dim=-1),
        "sqrt((xyz * xyz).sum(-1))": torch.sqrt((t * t).sum(-1)),
        "fma chain, fp32 sqrt": torch.sqrt(r2),
        "fma chain, fp64 sqrt": torch.sqrt(r2.double()).float(),
    }
    for name, r in rngs.items():
        print(f"range {name}: {int((r.numpy() != jrng).sum())} differ from JAX")
    # Ties: ranges on a coarse grid over few pixels.
    rng = np.random.default_rng(1)
    row = rng.integers(0, 64, n).astype(np.int32)
    col = rng.integers(0, 1800, n).astype(np.int32) // 16 * 16
    dist = (rng.integers(0, 8, n) * 0.5).astype(np.float32)
    want_w, want_h = _j_winners(row, col, dist, 64, 1800)
    got_w, got_h = tproj.z_buffer_winner_map(
        torch.from_numpy(row), torch.from_numpy(col), torch.from_numpy(dist),
        height=64, width=1800)
    print(f"winners: {int(want_h.sum())} pixels hit, has differs at "
          f"{int((got_h.numpy() != want_h).sum())}, winner at "
          f"{int((got_w.numpy() != want_w).sum())}")
    keys = rng.integers(0, 3, (8000, 16)).astype(np.float32)
    payload = np.broadcast_to(np.arange(16, dtype=np.float32)[:, None], (8000, 16, 1))
    _, order = sort_with_payload(torch.from_numpy(keys), torch.from_numpy(payload.copy()))
    _, jorder = jsorting.sort_with_payload(jnp.asarray(keys), jnp.asarray(payload))
    stable = np.argsort(keys, kind="stable", axis=-1)
    differ = int((order[..., 0].numpy() != stable).any(-1).sum())
    print(f"bitonic network (port) vs stable sort: {differ} of 8000 rows of 16 keys in "
          f"3 values ordered otherwise; port vs JAX: "
          f"{int((order[..., 0].numpy() != np.asarray(jorder)[..., 0]).any(-1).sum())}")


if __name__ == "__main__":
    study()
