"""The port's parcel predict against the JAX package on the CPU:
`stratanet2_tpu_torch/inference/{polygons,shapefile_io,rasters,tiling}.py`
and `utils/worklist.py`, copies of the JAX package's host modules, give
equal results bit for bit on the same numpy inputs (the raster bands also
against the reference oracles of `utils/reference_oracle.py`); and
`inference/predict.predict_parcel` gives JAX's merged tif, pseudo-labels,
per-plot tifs and shapefile fields at `tests/synthetic.tiny_config()` sizes
(N=256, k 8/16, batch 4), for a chain of 1 and a ragged chain of 2.

Tolerance of predict_parcel: PARITY_ATOL = 2e-5, the serve step's (the port
folds BN and distributes SA layer 1, JAX's CPU path does neither:
tests/test_torch_port_model.py), on every band of the merged tif, the
pseudo-label coverages and the PRED_* fields; the merge is a convex
combination of tile values, so it adds nothing to that. Where the serve
steps agree, the port's chained and per-batch runs agree bit for bit.

Tiling takes scipy's disk query here, on both sides, and the numpy min z:
this file builds no native library.
"""

import os
import pickle
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratanet2_tpu.data import native as jnative
from stratanet2_tpu.data.las import write_las as jax_write_las
from stratanet2_tpu.inference import geotiff as jgeotiff
from stratanet2_tpu.inference import polygons as jpolygons
from stratanet2_tpu.inference import predict as jpredict
from stratanet2_tpu.inference import rasters as jrasters
from stratanet2_tpu.inference import shapefile_io as jshp
from stratanet2_tpu.inference import tiling as jtiling
from stratanet2_tpu.models import PointNet2Params, init_pointnet2 as jax_init
from stratanet2_tpu.utils import reference_oracle as oracle
from stratanet2_tpu.utils import worklist as jworklist
from stratanet2_tpu_torch.config import Config
from stratanet2_tpu_torch.data import native
from stratanet2_tpu_torch.inference import geotiff, polygons, predict, rasters, shapefile_io, tiling
from stratanet2_tpu_torch.utils import worklist
from stratanet2_tpu_torch.utils.convert import from_jax_params
from stratanet2_tpu_torch.utils.synthetic import cloud_to_las_fields
from synthetic import make_plot_cloud, tiny_config

torch.set_num_threads(1)

PARITY_ATOL = 2e-5


@pytest.fixture(autouse=True)
def numpy_paths(monkeypatch):
    """scipy's disk query and numpy's min z on both sides."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jnative, "available", lambda: False)


def _ring(rng, center, radius, n=40):
    """A star-shaped ring around `center`, closed, with jittered radii."""
    t = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = radius * rng.uniform(0.6, 1.0, n)
    ring = np.stack([center[0] + r * np.cos(t), center[1] + r * np.sin(t)], 1)
    return np.concatenate([ring, ring[:1]])


def _polygon_rings(rng):
    """An exterior ring and a hole inside it (the even-odd rule)."""
    return [_ring(rng, (50.0, 50.0), 40.0), _ring(rng, (50.0, 50.0), 12.0)]


def _square(mod, x0, y0, w):
    return mod.Polygon([np.array([[x0, y0], [x0 + w, y0], [x0 + w, y0 + w], [x0, y0 + w]])])


# ---------------------------------------------------------------------------
# polygons
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_polygon_geometry_matches_jax(seed):
    """contains (ray cast with a hole), its scanline form, the boundary
    distance, buffered containment both ways and the bounds."""
    rng = np.random.default_rng(seed)
    rings = _polygon_rings(rng)
    mine, theirs = polygons.Polygon(rings), jpolygons.Polygon(rings)
    pts = rng.uniform(0, 100, (3000, 2))
    inside = mine.contains(pts)
    np.testing.assert_array_equal(inside, theirs.contains(pts))
    assert 0.2 < inside.mean() < 0.8
    assert not mine.contains(np.array([[50.0, 50.0]]))[0]  # the hole's centre
    xs, ys = np.linspace(0, 100, 57), np.linspace(100, 0, 43)
    np.testing.assert_array_equal(mine.contains_grid(xs, ys), theirs.contains_grid(xs, ys))
    np.testing.assert_array_equal(mine.boundary_distance(pts), theirs.boundary_distance(pts))
    for buffer in (-3.0, 0.0, 5.0):
        np.testing.assert_array_equal(polygons.keep_points_in_shape(pts, mine, buffer),
                                      jpolygons.keep_points_in_shape(pts, theirs, buffer))
        np.testing.assert_array_equal(polygons.keep_points_outside_shape(pts, mine, buffer),
                                      jpolygons.keep_points_outside_shape(pts, theirs, buffer))
    assert mine.bounds() == theirs.bounds()


@pytest.mark.parametrize("seed", [0, 1])
def test_raster_morphology_matches_jax(seed):
    """Connected components (4 and 8), the sieve with and without a mask,
    and the per-component disk erosion, on random blobs."""
    rng = np.random.default_rng(seed)
    mask = rng.uniform(0, 1, (48, 53)) < 0.55
    for conn in (4, 8):
        got, want = polygons.connected_components(mask, conn), jpolygons.connected_components(mask, conn)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] > 1
    values = mask.astype(np.int16)
    nodata = rng.uniform(0, 1, mask.shape) < 0.1
    for m in (None, nodata):
        np.testing.assert_array_equal(polygons.sieve(values, 5, mask=m),
                                      jpolygons.sieve(values, 5, mask=m))
    for radius in (1.5, 2.7):
        eroded = polygons.erode_disk(mask, radius)
        np.testing.assert_array_equal(eroded, jpolygons.erode_disk(mask, radius))
        assert eroded.sum() < mask.sum()


# ---------------------------------------------------------------------------
# shapefiles
# ---------------------------------------------------------------------------


def _shapefile(mod, pmod, rng):
    rings = _polygon_rings(rng)
    return mod.Shapefile(
        fields=[mod.FieldSpec("ID", "C", 16), mod.FieldSpec("AREA", "N", 8),
                mod.FieldSpec("SCORE", "F", 20, 10)],
        shape_records=[
            mod.ShapeRecord(pmod.Polygon(rings), {"ID": "PARCEL_1", "AREA": 4321, "SCORE": 0.25}),
            mod.ShapeRecord(None, {"ID": "EMPTY", "AREA": 0, "SCORE": None}),
            mod.ShapeRecord(pmod.Polygon(rings[:1]), {"ID": "PARCEL_3", "AREA": 7,
                                                       "SCORE": 123456.123456789}),
        ],
    )


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shapefile_written_by_one_side_reads_on_the_other(rng, tmp_path, writer):
    """Polygons with holes, a null shape and C/N/F fields: each package
    reads what the other wrote, and both write the same bytes."""
    write = {"port": (shapefile_io, polygons), "jax": (jshp, jpolygons)}
    mod, pmod = write[writer]
    path = str(tmp_path / writer / "parcels.shp")
    mod.write_shapefile(path, _shapefile(mod, pmod, np.random.default_rng(5)))
    got, want = shapefile_io.read_shapefile(path), jshp.read_shapefile(path)
    assert [(f.name, f.ftype, f.length, f.decimals) for f in got.fields] == \
        [(f.name, f.ftype, f.length, f.decimals) for f in want.fields]
    assert [sr.record for sr in got.shape_records] == [sr.record for sr in want.shape_records]
    for g, w in zip(got.shape_records, want.shape_records):
        assert (g.shape is None) == (w.shape is None)
        if g.shape is not None:
            for gr, wr in zip(g.shape.rings, w.shape.rings):
                np.testing.assert_array_equal(gr, wr)
    np.testing.assert_array_equal(got.get_shape("PARCEL_3").exterior,
                                  want.get_shape("PARCEL_3").exterior)
    other = str(tmp_path / "other" / "parcels")
    (jshp if writer == "port" else shapefile_io).write_shapefile(other, want)
    for ext in (".shp", ".shx", ".dbf"):
        with open(path[:-4] + ext, "rb") as a, open(other + ext, "rb") as b:
            assert a.read() == b.read(), ext


# ---------------------------------------------------------------------------
# rasters
# ---------------------------------------------------------------------------


def _tiles(rng, mod, dp=20, offsets=((0, 0), (0, 13), (13, 7), (5, 21)), rim=True):
    """Tiles of [3 scores | 3 weight bands] with NaN holes, at pixel offsets
    (row, col) of a 1 m grid; also the offsets and the bands. The weight
    bands are predict's (NaN outside the disk, where the scores are not),
    or with `rim=False` random weights NaN where the scores are."""
    tiles, bands_all = [], []
    for r0, c0 in offsets:
        bands = rasters.add_weights_band_to_rasters(
            rng.uniform(0, 1, (3, dp, dp)).astype(np.float32), dp)
        if not rim:
            bands[3:] = rng.uniform(0.5, 1.5, (3, dp, dp))
        bands[:3][:, rng.integers(0, dp, 30), rng.integers(0, dp, 30)] = np.nan
        bands[3:] = np.where(np.isnan(bands[:3]), np.nan, bands[3:])
        bands_all.append(bands)
        tiles.append(mod.GeoTiff(bands=bands, geotransform=[1000.0 + c0, 1.0, 0.0,
                                                            2000.0 - r0, 0.0, -1.0]))
    return tiles, list(offsets), bands_all


def test_weights_hard_and_admissibility_bands_match_jax_and_the_oracles(rng):
    """The weight bands (and reference_weight_bands), the hard medium-veg
    band (and reference_hard_med_veg_band's 10001-threshold scan), the
    admissibility band and finalize, bit for bit."""
    r = rng.uniform(0, 1, (3, 20, 20)).astype(np.float32)
    got = rasters.add_weights_band_to_rasters(r, 20)
    np.testing.assert_array_equal(got, jrasters.add_weights_band_to_rasters(r, 20))
    np.testing.assert_array_equal(got, oracle.reference_weight_bands(r, 20).astype(np.float32))
    mosaic = rng.uniform(0, 1, (4, 25, 30))
    mosaic[1, rng.integers(0, 25, 60), rng.integers(0, 30, 60)] = np.nan
    hard = rasters.insert_hard_med_veg_raster_band(mosaic.astype(np.float32))
    np.testing.assert_array_equal(
        hard, jrasters.insert_hard_med_veg_raster_band(mosaic.astype(np.float32)))
    want = oracle.reference_hard_med_veg_band(mosaic.copy())
    np.testing.assert_array_equal(hard[3], want[3].astype(np.float32))
    blocks = np.zeros((4, 30, 30), np.float32)
    blocks[0], blocks[1] = 0.3, 0.6
    blocks[3, 5:15, 5:15] = 1.0
    blocks[3, 20:22, 20:22] = 1.0  # smaller than the sieve's 5 pixels
    blocks[:, 0, :4] = np.nan
    for m in (hard[:4], blocks):
        adm = rasters.insert_admissibility_raster(m, px_per_meter=1.0)
        np.testing.assert_array_equal(adm, jrasters.insert_admissibility_raster(m, 1.0))
    assert adm[4, 10, 10] == 0.0 and adm[4, 29, 0] == pytest.approx(0.6)  # the blocks'
    assert adm[4, 21, 21] == pytest.approx(0.6)  # the sieve removed the small block
    np.testing.assert_array_equal(rasters.finalize_merged_raster(mosaic.astype(np.float32)),
                                  jrasters.finalize_merged_raster(mosaic.astype(np.float32)))


@pytest.mark.parametrize("from_files", [False, True])
def test_merge_crop_and_parcel_values_match_jax_and_the_oracle(tmp_path, from_files):
    """merge_geotiff_rasters on in-memory tiles (`tiles=`) and on tile
    files, with and without a parcel shape: JAX's file bit for bit, the
    crop and the parcel's band means too. Its score bands also equal
    reference_merge_rasters' weighted average within float32 rounding, on
    tiles whose weights are NaN only where their scores are (the oracle
    copies its first tile as it is, scores without weights included, as
    rasterio's merge does)."""
    rng = np.random.default_rng(5)
    tiles, offsets, bands = _tiles(rng, geotiff)
    jtiles, _, _ = _tiles(np.random.default_rng(5), jgeotiff)
    shape_rings = [np.array([[1003.0, 1968.0], [1040.0, 1975.0], [1030.0, 2000.0],
                             [1002.0, 1995.0]])]
    for shape in (None, shape_rings):
        got_p, want_p = str(tmp_path / f"got{shape is None}.tif"), str(tmp_path / f"w{shape is None}.tif")
        mine = polygons.Polygon(shape) if shape else None
        theirs = jpolygons.Polygon(shape) if shape else None
        if from_files:
            paths = []
            for i, t in enumerate(tiles):
                paths.append(str(tmp_path / "tiles" / f"{i}.tif"))
                geotiff.write_geotiff(paths[-1], t.bands, t.geotransform)
            rasters.merge_geotiff_rasters(got_p, paths, mine)
            jrasters.merge_geotiff_rasters(want_p, paths, theirs)
        else:
            rasters.merge_geotiff_rasters(got_p, (), mine, tiles=tiles)
            jrasters.merge_geotiff_rasters(want_p, (), theirs, tiles=jtiles)
        got, want = geotiff.read_geotiff(got_p), jgeotiff.read_geotiff(want_p)
        np.testing.assert_array_equal(got.bands, want.bands)
        assert got.geotransform == want.geotransform and got.band_names == want.band_names
        assert rasters.get_parcel_predicted_values(got_p) == \
            jrasters.get_parcel_predicted_values(want_p)
        if shape is not None:
            assert np.isnan(got.bands[:, -1, -1]).all()  # cut by the shape
    plain, offsets, bands = _tiles(np.random.default_rng(6), geotiff, rim=False)
    rasters.merge_geotiff_rasters(str(tmp_path / "plain.tif"), (), tiles=plain)
    got = geotiff.read_geotiff(str(tmp_path / "plain.tif"))
    ref = oracle.reference_merge_rasters(bands, offsets, max(r for r, _ in offsets) + 20,
                                         max(c for _, c in offsets) + 20)
    np.testing.assert_allclose(np.nan_to_num(got.bands[:3]),
                               np.nan_to_num(ref[:3].astype(np.float32)), rtol=1e-5, atol=1e-6)
    assert rasters.get_parcel_predicted_values(None) == jrasters.get_parcel_predicted_values(None)
    gt = [0.0, 1.0, 0.0, 10.0, 0.0, -1.0]
    m = np.ones((6, 10, 10), np.float32)
    np.testing.assert_array_equal(
        rasters.crop_merged_raster(m, _square(polygons, 0, 0, 5), gt),
        jrasters.crop_merged_raster(m, _square(jpolygons, 0, 0, 5), gt))
    assert rasters.merge_geotiff_rasters(str(tmp_path / "none.tif"), (), tiles=[]) == \
        jrasters.merge_geotiff_rasters(str(tmp_path / "none.tif"), (), tiles=[])


# ---------------------------------------------------------------------------
# tiling and the worklist
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("diam", [(20, 20), (40, 20)])
def test_plot_centers_match_jax(diam):
    diam_pix, diam_meters = diam
    rings = [_ring(np.random.default_rng(2), (650_050.0, 6_860_050.0), 60.0)]
    args = ((649_990.0, 650_110.0), (6_859_990.0, 6_860_110.0))
    got = tiling.get_plot_centers(*args, polygons.Polygon(rings), diam_pix, diam_meters)
    want = jtiling.get_plot_centers(*args, jpolygons.Polygon(rings), diam_pix, diam_meters)
    assert len(got) == len(want) > 20
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def _parcel_las(tmp_path, rng, size=40.0, per_plot=800):
    """A synthetic parcel LAS of size x size m, clouds around its quarter
    centres; returns the path and the parcel's square in both packages."""
    clouds = [make_plot_cloud(rng, n=per_plot, center=(cx, cy), radius=12)
              for cx in (size / 4, 3 * size / 4) for cy in (size / 4, 3 * size / 4)]
    path = str(tmp_path / "PARCEL1.las")
    jax_write_las(path, cloud_to_las_fields(np.concatenate(clouds, axis=1)))
    return path, _square(polygons, 0, 0, size), _square(jpolygons, 0, 0, size)


def test_parcel_tiling_and_extraction_match_jax(tmp_path):
    """divide_parcel_las_and_get_disk_centers and extract_plots_from_parcel
    (scipy's disk query, the min-points filter, pre_transform): the same
    centres, parcel cloud and plots, bit for bit."""
    jcfg = tiny_config()
    pcfg = port_config(jcfg)
    path, mine, theirs = _parcel_las(tmp_path, np.random.default_rng(0))
    centers, cloud = tiling.divide_parcel_las_and_get_disk_centers(pcfg, path, mine)
    jcenters, jcloud = jtiling.divide_parcel_las_and_get_disk_centers(jcfg, path, theirs)
    np.testing.assert_array_equal(np.stack(centers), np.stack(jcenters))
    np.testing.assert_array_equal(cloud, jcloud)
    plots = tiling.extract_plots_from_parcel(pcfg, cloud, centers)
    want = jtiling.extract_plots_from_parcel(jcfg, jcloud, jcenters)
    assert list(plots) == list(want) and len(plots) >= 4
    assert len(plots) < len(centers)  # the min-points filter drops the rim's plots
    for pid in want:
        for key, value in want[pid].items():
            np.testing.assert_array_equal(plots[pid][key], value, err_msg=f"{pid} {key}")
    assert tiling.define_plot_id(7, (650_001.9, 6_860_000.2)) == \
        jtiling.define_plot_id(7, (650_001.9, 6_860_000.2))
    assert tiling.extract_plots_from_parcel(pcfg, cloud, []) == {}


def test_worklist_matches_jax(tmp_path):
    inputs, outputs = tmp_path / "in", tmp_path / "out"
    inputs.mkdir()
    outputs.mkdir()
    for i in range(12):
        (inputs / f"PARCEL_{i:03d}.las").write_bytes(b"")
    for i in (2, 5):
        (outputs / f"PARCEL_{i:03d}.tif").write_bytes(b"")
    for hosts in (1, 3):
        for host in range(hosts):
            got = worklist.get_unprocessed_files(str(inputs), str(outputs), host, hosts, 7)
            assert got == jworklist.get_unprocessed_files(str(inputs), str(outputs), host,
                                                          hosts, 7)
            assert all(worklist.stem(p) not in ("PARCEL_002", "PARCEL_005") for p in got)
    assert sorted(worklist.files_in(str(inputs))) == sorted(jworklist.files_in(str(inputs)))
    assert worklist.host_shard_of("a/PARCEL_001.las", 5) == \
        jworklist.host_shard_of("a/PARCEL_001.las", 5)


# ---------------------------------------------------------------------------
# predict_parcel
# ---------------------------------------------------------------------------


def port_config(jcfg, **data):
    """The port's Config for the JAX tiny config `jcfg`."""
    m, t = jcfg.model, jcfg.train
    cfg = Config().as_dev()
    return replace(
        cfg,
        model=replace(cfg.model, subsample_size=m.subsample_size, k1=m.k1, k2=m.k2),
        train=replace(cfg.train, batch_size=t.batch_size),
        data=replace(cfg.data, **data),
    )


def _plots():
    """The 10-plot set of tests/test_inference.py::
    test_predict_program_matches_per_batch: 3 batches of 4, the last
    ragged."""
    rng = np.random.default_rng(3)
    plots = {}
    for i in range(10):
        cx, cy = 10 + 20 * (i % 3), 10 + 20 * (i // 3)
        cloud = make_plot_cloud(rng, n=500, center=(cx, cy), radius=9)
        pid = f"PP{i:08d}_X{cx}_Y{cy}"
        plots[pid] = {"cloud": cloud, "N_points_in_cloud": cloud.shape[1],
                      "plot_center": np.array([float(cx), float(cy)]), "plot_id": pid,
                      "index": i, "coverages": np.array([])}
    return plots


@pytest.fixture(scope="module")
def models():
    """JAX's init_pointnet2 at the tiny config with random BN scale, bias
    and running statistics, and the port's model from the same weights."""
    rng = np.random.default_rng(11)
    jcfg = tiny_config()
    model = jax_init(jax.random.PRNGKey(0), jcfg.model)
    params = jax.tree_util.tree_map(np.asarray, model.params)
    state = jax.tree_util.tree_map(np.asarray, model.state)
    for name in state:
        for lp, ls in zip(params[name]["layers"], state[name]["layers"]):
            c = ls["mean"].shape[0]
            lp["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            lp["bn"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
            ls["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            ls["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    jmodel = PointNet2Params(jax.tree_util.tree_map(jnp.asarray, params),
                             jax.tree_util.tree_map(jnp.asarray, state))
    return jmodel, from_jax_params(params, state, port_config(jcfg).model, device="cpu")


def _run(side, models, chain, out, task, keep=False, max_batches=None):
    """One predict_parcel of `side` over the 10 plots (3000 points each
    for pseudo-labelling): the tif's bands, or the labelled coverages."""
    jmodel, pmodel = models
    jcfg = tiny_config()
    data = dict(predict_chain=chain, keep_plot_tiffs=keep)
    plots = _plots()
    if task == "pseudo_labelling":
        plots = {k: dict(v, N_points_in_cloud=3000) for k, v in plots.items()}
    if side == "jax":
        cfg = replace(jcfg, data=replace(jcfg.data, **data))
        path = jpredict.predict_parcel(jmodel, plots, cfg, "PARCEL1", str(out), task=task,
                                       parcel_shape=_square(jpolygons, 0, 0, 80),
                                       max_batches=max_batches)
    else:
        path = predict.predict_parcel(pmodel, plots, port_config(jcfg, **data), "PARCEL1",
                                      str(out), task=task,
                                      parcel_shape=_square(polygons, 0, 0, 80),
                                      max_batches=max_batches, device="cpu")
    assert not [f for f in os.listdir(out) if f.endswith(".tmp")]
    if task == "pseudo_labelling":
        with open(path, "rb") as f:
            return {k: v["coverages"] for k, v in pickle.load(f).items()}
    return geotiff.read_geotiff(path)


@pytest.fixture(scope="module")
def jax_runs(models, tmp_path_factory):
    """JAX's runs, chain 1 (with keep_plot_tiffs) and 2, both tasks: the
    result of each and its output folder."""
    root = tmp_path_factory.mktemp("jax_parcel")
    return {(chain, task): (_run("jax", models, chain, root / f"{chain}_{task}", task,
                                 keep=chain == 1), root / f"{chain}_{task}")
            for chain in (1, 2) for task in ("inference", "pseudo_labelling")}


@pytest.mark.parametrize("chain", [1, 2])
def test_predict_parcel_inference_matches_jax(models, jax_runs, tmp_path, chain):
    """The merged 6-band tif (chain 2: 3 batches, so the last chain holds
    one; JAX pads it with an all-invalid batch), the per-plot tifs of
    keep_plot_tiffs, and the
    updated shapefile's PRED_* fields, within PARITY_ATOL."""
    got = _run("port", models, chain, tmp_path / "out", "inference")
    want, _ = jax_runs[(chain, "inference")]
    assert got.band_names == want.band_names == rasters.FINAL_RASTER_BANDNAMES
    assert got.geotransform == want.geotransform and got.bands.shape == want.bands.shape
    np.testing.assert_array_equal(np.isnan(got.bands), np.isnan(want.bands))
    np.testing.assert_allclose(got.bands, want.bands, rtol=0, atol=PARITY_ATOL)
    assert np.isfinite(got.bands[0]).sum() > 1000
    assert not os.path.exists(tmp_path / "out" / "PARCEL1")  # no per-plot tifs by default
    # the shapefile update, against JAX's band means of its merged tif
    shp = str(tmp_path / "input" / "parcels.shp")
    shapefile_io.write_shapefile(shp, shapefile_io.Shapefile(
        fields=[shapefile_io.FieldSpec("ID", "C", 16)],
        shape_records=[shapefile_io.ShapeRecord(_square(polygons, 0, 0, 80), {"ID": "PARCEL1"}),
                       shapefile_io.ShapeRecord(_square(polygons, 90, 0, 10), {"ID": "OTHER"})]))
    out_shp = predict.update_shapefile_with_predictions(shp, str(tmp_path / "out"))
    records = [sr.record for sr in shapefile_io.read_shapefile(out_shp).shape_records]
    want_values = jrasters.get_parcel_predicted_values(
        _write_bands(tmp_path / "jax.tif", want))
    for field, value in want_values.items():
        assert abs(records[0][field] - value) <= PARITY_ATOL, field
        assert 0 <= records[0][field] <= 1
        assert records[1][field] == -1.0  # no tif for that parcel
    assert set(rasters.SHP_FIELDS_NAME_DICT) <= set(records[0])


def _write_bands(path, tif):
    jgeotiff.write_geotiff(str(path), tif.bands, tif.geotransform, band_names=tif.band_names)
    return str(path)


def test_keep_plot_tiffs_writes_jax_files(models, jax_runs, tmp_path):
    """keep_plot_tiffs: each plot's [3 scores | 3 weights] tif, as JAX
    writes it, within PARITY_ATOL, beside the merged tif (chain 1)."""
    _run("port", models, 1, tmp_path / "port", "inference", keep=True)
    _, jax_dir = jax_runs[(1, "inference")]
    ours, theirs = sorted(os.listdir(tmp_path / "port" / "PARCEL1")), sorted(
        os.listdir(jax_dir / "PARCEL1"))
    assert ours == theirs and len(ours) == 10
    for name in ours:
        got = geotiff.read_geotiff(str(tmp_path / "port" / "PARCEL1" / name))
        want = jgeotiff.read_geotiff(str(jax_dir / "PARCEL1" / name))
        assert got.geotransform == want.geotransform
        np.testing.assert_array_equal(np.isnan(got.bands), np.isnan(want.bands))
        np.testing.assert_allclose(got.bands, want.bands, rtol=0, atol=PARITY_ATOL)


@pytest.mark.parametrize("chain", [1, 2])
def test_predict_parcel_pseudo_labels_match_jax(models, jax_runs, tmp_path, chain):
    """The pseudo-labelled pickle: the same plots, coverages within
    PARITY_ATOL; written through a .tmp file that is gone afterwards."""
    got = _run("port", models, chain, tmp_path, "pseudo_labelling")
    want, _ = jax_runs[(chain, "pseudo_labelling")]
    assert list(got) == list(want) and len(got) == 10
    for pid in want:
        assert got[pid].shape == (4,)
        np.testing.assert_allclose(got[pid], want[pid], rtol=0, atol=PARITY_ATOL)


def test_chained_predict_equals_per_batch(models, tmp_path):
    """Chains of 1, 2 (ragged: 3 batches) and 8 (one chain of 3 batches)
    give the same merged tif and pseudo-labels bit for bit; a batch cap
    leaves the later plots out of the pickle."""
    outs = {chain: (_run("port", models, chain, tmp_path / f"{chain}", "inference"),
                    _run("port", models, chain, tmp_path / f"{chain}_pl", "pseudo_labelling"))
            for chain in (1, 2, 8)}
    tif1, cov1 = outs[1]
    for chain in (2, 8):
        tif, cov = outs[chain]
        np.testing.assert_array_equal(tif.bands, tif1.bands)
        assert list(cov) == list(cov1)
        for pid in cov1:
            np.testing.assert_array_equal(cov[pid], cov1[pid])
    plots = {k: {f: v for f, v in d.items() if f != "coverages"} | {"N_points_in_cloud": 3000}
             for k, d in _plots().items()}  # as tiling extracts them: no coverages yet
    cfg = port_config(tiny_config(), predict_chain=2)
    path = predict.predict_parcel(models[1], plots, cfg, "CAP", str(tmp_path / "cap"),
                                  task="pseudo_labelling", max_batches=1, device="cpu")
    with open(path, "rb") as f:
        capped = pickle.load(f)
    assert list(capped) == list(cov1)[:4]
    for pid in capped:
        np.testing.assert_array_equal(capped[pid]["coverages"], cov1[pid])


@pytest.mark.parametrize("chain,max_batches,sizes", [(2, None, [2, 2, 1]), (8, None, [5]),
                                                     (1, None, [1] * 5), (2, 3, [2, 1])])
def test_chain_batches_leave_the_last_chain_short(chain, max_batches, sizes):
    """Chains of `chain` loader batches, the last one shorter, no padding
    batch: the card runs the real batches only."""
    batches = [{"cloud": np.full((4, 8, 10), i)} for i in range(5)]
    groups = list(predict._chain_batches(iter(batches), chain, max_batches))
    assert [len(g) for g in groups] == sizes
    assert [b["cloud"][0, 0, 0] for g in groups for b in g] == list(range(sum(sizes)))


def test_predict_parcel_runs_each_batch_once_and_reads_each_chain_once(models, tmp_path,
                                                                       monkeypatch):
    """Chain 2 over 3 batches: the step runs 3 times, not 4, and the outputs
    come to the host in 2 copies, a chain's after the next chain is
    launched, the last one at the end."""
    events = []
    real_step, real_copy = predict.make_predict_step, predict._copy_to_host

    def counted_step(cfg, device=None, mesh=None):
        step = real_step(cfg, device, mesh)

        def run(*args):
            events.append("step")
            return step(*args)

        return run

    def counted_copy(out):
        events.append(("copy", out.shape[0]))
        return real_copy(out)

    monkeypatch.setattr(predict, "make_predict_step", counted_step)
    monkeypatch.setattr(predict, "_copy_to_host", counted_copy)
    cfg = port_config(tiny_config(), predict_chain=2)
    predict.predict_parcel(models[1], _plots(), cfg, "PARCEL1", str(tmp_path / "out"),
                           device="cpu")
    assert events == ["step", "step", ("copy", 2), "step", ("copy", 1)]
    host, done = real_copy(torch.ones(2, 3))
    assert done is None and torch.equal(host, torch.ones(2, 3))


def test_predict_program_stacks_the_steps(models):
    """make_predict_program over a stacked chain equals make_predict_step
    batch by batch, bit for bit, and returns (S, B, 3, P, P), (S, B, 4)."""
    _, pmodel = models
    cfg = port_config(tiny_config())
    rng = np.random.default_rng(4)
    clouds = rng.uniform(0, 1, (3, 4, 256, 10)).astype(np.float32)
    xyzs = rng.uniform(-10, 10, (3, 4, 256, 3)).astype(np.float32)
    rasters_s, preds_s = predict.make_predict_program(cfg, device="cpu")(pmodel, clouds, xyzs)
    assert rasters_s.shape == (3, 4, 3, 20, 20) and preds_s.shape == (3, 4, 4)
    step = predict.make_predict_step(cfg, device="cpu")
    for s in range(3):
        r, p = step(pmodel, clouds[s], xyzs[s])
        assert torch.equal(r.isnan(), rasters_s[s].isnan())
        assert torch.equal(torch.nan_to_num(r), torch.nan_to_num(rasters_s[s]))
        assert torch.equal(p, preds_s[s])


def test_all_invalid_parcel_returns_none(models, tmp_path, monkeypatch):
    """A parcel whose batches are all invalid writes no tif and returns None,
    as JAX's does; no plot with enough points for pseudo-labelling: None."""
    real_loader = predict.PlotLoader

    class AllInvalidLoader(real_loader):
        def __iter__(self):
            for batch in super().__iter__():
                batch["valid"][:] = False
                yield batch

    monkeypatch.setattr(predict, "PlotLoader", AllInvalidLoader)
    cfg = port_config(tiny_config())
    assert predict.predict_parcel(models[1], _plots(), cfg, "EMPTY", str(tmp_path / "out"),
                                  device="cpu") is None
    assert not os.path.exists(tmp_path / "out" / "EMPTY.tif")
    assert predict.predict_parcel(models[1], _plots(), cfg, "FEW", str(tmp_path / "pl"),
                                  task="pseudo_labelling", device="cpu") is None


def test_predict_entry_points_need_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config(tiny_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.make_predict_program(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.predict_parcel(None, _plots(), cfg, "P", "unused")
    predict.make_predict_program(cfg, device="cpu")
