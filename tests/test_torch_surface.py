"""The port's v2 surface modules and helpers against the JAX package's on the
CPU, on the same inputs:

- ``model.save_model``'s tar loads in the JAX package's ``load_model`` and
  the reverse, bit for bit; with a master of either package, one trainer
  per window wins the save and the other skips;
- ``utils.model_tools``: ``merge_model`` bundles cross-load both ways with
  equal manifests, ``make_diagram`` text is equal for one topology and
  ``dump_config`` is equal on tests/configs/demo_mnist_mlp.py;
- ``utils.plotcurve``: ``parse_log`` and ``main``'s table equal on a log
  sample; ``plot.Ploter`` records and renders, and stays silent with
  DISABLE_PLOT;
- ``utils.preprocess_img``: the cases of tests/test_preprocess_img.py, each
  on the port with its batches, meta and reader rows equal to the JAX
  package's on the same image tree;
- the helpers ``core.batch.non_seq``, ``core.compiler.count_params``,
  ``core.initializers.uniform`` (by shape, bounds and moments: the random
  streams differ), ``ops.needs_f32_acc``, ``utils.flags.all_flags`` and
  ``utils.debug.profile_layers``, ``format_layer_profile`` and
  ``gradient_stats`` (norms within 1e-5 relative).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu import model as jmodel
from paddle_tpu import plot as jplot
from paddle_tpu.utils import model_tools as jmt
from paddle_tpu.utils import plotcurve as jpc
from paddle_tpu.utils import preprocess_img as jpp
from paddle_tpu_torch import model as tmodel
from paddle_tpu_torch import plot as tplot
from paddle_tpu_torch.core.compiler import CompiledNetwork as TNet
from paddle_tpu_torch.core.topology import Topology as TTopo
from paddle_tpu_torch.utils import model_tools as tmt
from paddle_tpu_torch.utils import plotcurve as tpc
from paddle_tpu_torch.utils import preprocess_img as tpp
from test_torch_parity import (assert_trees_equal, batch_both, build_both, carry, demo_mlp,
                               mlp_batch, mlp_samples)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "tests", "configs", "demo_mnist_mlp.py")
PIXELS, CLASSES = 12, 3


def small_mlp():
    return build_both(lambda pkg: demo_mlp(pkg, hidden=(8,), classes=CLASSES, pixels=PIXELS)[0])


def both_params(seed_j=3, seed_t=5):
    jcost, tcost = small_mlp()
    return (paddle_tpu.parameters.create(jcost, seed=seed_j),
            paddle_tpu_torch.parameters.create(tcost, seed=seed_t, device="cpu"))


def test_save_model_tars_load_in_both_packages(tmp_path):
    jparams, tparams = both_params()
    path = tmodel.save_model(tparams, str(tmp_path / "port" / "model.tar"))
    assert path == str(tmp_path / "port" / "model.tar")
    jmodel.load_model(jparams, path)
    assert_trees_equal(jparams.params, tparams.params)
    jparams2, tparams2 = both_params(seed_j=7, seed_t=9)
    jpath = jmodel.save_model(jparams2, str(tmp_path / "jax.tar"))
    tmodel.load_model(tparams2, jpath)
    assert_trees_equal(tparams2.params, jparams2.params)
    # with a master, one trainer per window wins the save (the JAX
    # package's master arbitrates the port's save and the reverse)
    from paddle_tpu import master as jmaster
    from paddle_tpu_torch import master as tmaster

    for smod, cmod, saver, loader, params in ((jmaster, tmaster, tmodel, jmodel, tparams),
                                              (tmaster, jmaster, jmodel, tmodel, jparams)):
        srv = smod.Server(smod.Service())
        try:
            first = cmod.Client(srv.address, trainer_id="first")
            got = saver.save_model(params, str(tmp_path / "fleet"), master=first)
            assert got == str(tmp_path / "fleet" / "first" / "model.tar")
            other = cmod.Client(srv.address, trainer_id="other")
            assert saver.save_model(params, str(tmp_path / "fleet"), master=other) is None
            first.close()
            other.close()
        finally:
            srv.close()
        loader.load_model(jparams2 if loader is jmodel else tparams2, got)
    assert_trees_equal(jparams2.params, tparams.params)
    assert_trees_equal(tparams2.params, jparams.params)
    assert isinstance(tmodel.trainer_id, str) and len(tmodel.trainer_id) == 36


def test_merged_models_cross_load(tmp_path):
    jparams, tparams = both_params()
    tpath, jpath = str(tmp_path / "port.tgz"), str(tmp_path / "jax.tgz")
    tmt.merge_model(tparams, tpath)
    jmt.merge_model(jparams, jpath)
    jfresh, tfresh = both_params(seed_j=11, seed_t=13)
    assert jmt.load_merged_model(tpath, jfresh) == tmt.load_merged_model(jpath, tfresh)
    assert_trees_equal(jfresh.params, tparams.params)
    assert_trees_equal(tfresh.params, jparams.params)
    other = paddle_tpu_torch.parameters.create(
        demo_mlp(paddle_tpu_torch, hidden=(4,), classes=CLASSES, pixels=PIXELS)[0], device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        tmt.load_merged_model(jpath, other)


def test_make_diagram_and_dump_config_match(tmp_path):
    jcost, tcost = small_mlp()
    dot = tmt.make_diagram(TTopo([tcost]), str(tmp_path / "m.dot"))
    assert dot == jmt.make_diagram(paddle_tpu.Topology([jcost]))
    assert open(tmp_path / "m.dot").read() == dot and "doubleoctagon" in dot
    for arg in ("", "is_predict=1"):
        assert tmt.dump_config(CONFIG, arg) == jmt.dump_config(CONFIG, arg)


LOG = """I1017 Pass 0: mean cost 2.302585
batch 10 AvgCost=1.9 CurrentEval: classification_error_evaluator=0.75
batch 20 AvgCost=1.5e-0 classification_error_evaluator=0.5
epoch 1 cost 1.234567 lr=1e-3
Pass 1: mean cost 0.912345
nothing to see here
"""


def test_plotcurve_matches(tmp_path, capsys):
    assert tpc.parse_log(LOG.splitlines()) == jpc.parse_log(LOG.splitlines())
    path = tmp_path / "train.log"
    path.write_text(LOG)
    outs = []
    for mod in (jpc, tpc):
        assert mod.main(["-i", str(path)]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "cost: n=" in outs[1]
    assert tpc.main(["-i", str(path), "-o", str(tmp_path / "c.png")]) == 0
    assert (tmp_path / "c.png").stat().st_size > 0
    empty = tmp_path / "empty.log"
    empty.write_text("no metrics\n")
    assert tpc.main(["-i", str(empty)]) == 1


def test_ploter_records_and_renders(tmp_path, monkeypatch):
    for disabled in (True, False):
        if disabled:
            monkeypatch.setenv("DISABLE_PLOT", "True")
        else:
            monkeypatch.delenv("DISABLE_PLOT", raising=False)
        tp, jp = tplot.Ploter("train", "test"), jplot.Ploter("train", "test")
        for p in (tp, jp):
            for step in range(3):
                p.append("train", step, 1.0 / (step + 1))
        assert (tp.data("train").step, tp.data("train").value) == (
            jp.data("train").step, jp.data("train").value)
        png = tmp_path / f"curve{int(disabled)}.png"
        tp.plot(str(png))
        assert png.exists() is not disabled
        tp.reset()
        assert tp.data("train").step == [] and tp.data("test").value == []


# ---------------------------------------------------------------------------
# the cases of tests/test_preprocess_img.py, the port against the JAX package
# ---------------------------------------------------------------------------


def write_images(root, layout, seed, size=(12, 10, 3)):
    """layout: {split: {label: n images}} of random PNGs under root."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    for split, labels in layout.items():
        for label, n in labels.items():
            d = root / split / label
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.randint(0, 255, size=size, dtype=np.uint8)).save(
                    d / f"im{i}.png")
    return root


def both_trees(tmp_path, layout, seed):
    return {name: write_images(tmp_path / name, layout, seed) for name in ("jax", "torch")}


def test_create_batches_and_reader(tmp_path):
    trees = both_trees(tmp_path, {"train": {"cat": 6, "dog": 6}, "test": {"cat": 2, "dog": 2}}, 0)
    metas, rows = {}, {}
    for name, pp in (("jax", jpp), ("torch", tpp)):
        metas[name] = pp.ImageClassificationDatasetCreater(
            str(trees[name]), target_size=8, num_per_batch=5).create_batches()
        rows[name] = list(pp.batch_reader(str(trees[name] / "train.list"), metas[name])())
    meta = metas["torch"]
    assert meta["label_names"] == ["cat", "dog"] and meta["img_size"] == 8 * 8 * 3
    np.testing.assert_array_equal(meta["mean_image"], metas["jax"]["mean_image"])
    assert tpp.load_meta(str(trees["torch"]))["label_names"] == meta["label_names"]
    with open(trees["torch"] / "train.list") as f:
        assert len(f.read().split()) == 3
    assert len(rows["torch"]) == 12
    for (tx, tl), (jx, jl) in zip(rows["torch"], rows["jax"]):
        assert tl == jl
        np.testing.assert_array_equal(tx, jx)
    xs = np.stack([r[0] for r in rows["torch"]])
    assert sorted(r[1] for r in rows["torch"]) == [0] * 6 + [1] * 6
    np.testing.assert_allclose(xs.mean(axis=0), 0.0, atol=1e-3)


def test_disk_image_npy_and_png_agree(tmp_path):
    from PIL import Image

    arr = np.random.RandomState(1).randint(0, 255, size=(8, 8, 3), dtype=np.uint8)
    Image.fromarray(arr).save(tmp_path / "a.png")
    np.save(tmp_path / "a.npy", arr)
    png = tpp.DiskImage(str(tmp_path / "a.png"), 8).convert_to_paddle_format()
    npy = tpp.DiskImage(str(tmp_path / "a.npy"), 8).convert_to_paddle_format()
    np.testing.assert_allclose(png, npy)
    np.testing.assert_array_equal(png, jpp.DiskImage(str(tmp_path / "a.png"), 8)
                                  .convert_to_paddle_format())
    assert png.shape == (8 * 8 * 3,)
    assert tpp.list_images(str(tmp_path)) == jpp.list_images(str(tmp_path))


def test_test_split_labels_map_to_training_label_set(tmp_path):
    layout = {"train": {"ant": 1, "bee": 1, "cow": 1}, "test": {"bee": 1, "cow": 1}}
    root = write_images(tmp_path, layout, 2, size=(8, 8, 3))
    meta = tpp.ImageClassificationDatasetCreater(str(root), target_size=8).create_batches()
    rows = list(tpp.batch_reader(str(root / "test.list"))())
    assert sorted(r[1] for r in rows) == [1, 2]  # bee=1, cow=2 per training set
    assert meta["label_names"] == ["ant", "bee", "cow"]


def test_unknown_test_label_rejected(tmp_path):
    root = write_images(tmp_path, {"train": {"a": 1}, "test": {"a": 1, "zz": 1}}, 3,
                        size=(8, 8, 3))
    with pytest.raises(ValueError, match="zz"):
        tpp.ImageClassificationDatasetCreater(str(root), target_size=8).create_batches()


def test_small_npy_resized_like_png(tmp_path):
    arr = np.random.RandomState(4).randint(0, 255, size=(6, 6, 3), dtype=np.uint8)
    np.save(tmp_path / "small.npy", arr)
    vec = tpp.DiskImage(str(tmp_path / "small.npy"), 8).convert_to_paddle_format()
    assert vec.shape == (8 * 8 * 3,)
    np.testing.assert_array_equal(
        vec, jpp.DiskImage(str(tmp_path / "small.npy"), 8).convert_to_paddle_format())


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------


def test_non_seq_count_params_and_needs_f32_acc():
    from paddle_tpu.core.batch import non_seq as j_non_seq
    from paddle_tpu.core.compiler import count_params as j_count
    from paddle_tpu.ops import needs_f32_acc as j_needs
    from paddle_tpu_torch.core.batch import non_seq as t_non_seq
    from paddle_tpu_torch.core.compiler import count_params as t_count
    from paddle_tpu_torch.ops import needs_f32_acc as t_needs

    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    j, t = j_non_seq(x), t_non_seq(x, device="cpu")
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    assert t.lengths is None and j.lengths is None and t.data.device == torch.device("cpu")
    jparams, tparams = both_params()
    assert t_count(tparams.params) == j_count(jparams.params) == 12 * 8 + 8 + 8 * 3 + 3
    for jd, td in ((jnp.bfloat16, torch.bfloat16), (jnp.float16, torch.float16),
                   (jnp.float8_e4m3fn, torch.float8_e4m3fn), (jnp.float32, torch.float32),
                   (jnp.float64, torch.float64), (jnp.int32, torch.int32)):
        assert t_needs(td) == j_needs(jd), td


def test_uniform_by_shape_bounds_and_moments():
    from paddle_tpu.core.initializers import uniform as j_uniform
    from paddle_tpu_torch.core.initializers import uniform as t_uniform

    shape, scale, n = (100, 200), 0.3, 20000
    t = t_uniform(torch.Generator().manual_seed(1), shape, scale).numpy()
    j = np.asarray(j_uniform(jax.random.PRNGKey(1), shape, scale))
    # mean 0, variance scale^2 / 3; each within 5 sigma of its sampling spread
    mean_sigma = scale / np.sqrt(3 * n)
    var_sigma = scale**2 * np.sqrt(4 / 45 / n)
    for a in (t, j):
        assert a.shape == shape and a.dtype == np.float32
        assert a.min() >= -scale and a.max() < scale
        assert abs(a.mean()) <= 5 * mean_sigma
        assert abs(a.var() - scale**2 / 3) <= 5 * var_sigma
    assert t_uniform(torch.Generator().manual_seed(1), shape, scale, dtype=torch.float64).dtype \
        == torch.float64


def test_all_flags_agree_on_the_shared_flags():
    from paddle_tpu.utils import flags as jflags
    from paddle_tpu_torch.utils import flags as tflags

    j, t = jflags.all_flags(), tflags.all_flags()
    shared = set(j) & set(t)
    assert {"seed", "check_nans", "trainer_count", "use_tpu", "compute_dtype"} <= shared
    assert {k: t[k] for k in shared} == {k: j[k] for k in shared}
    assert set(t) == set(tflags._DEFS)


def test_layer_profile_and_gradient_stats_match():
    from paddle_tpu.utils import debug as jdebug
    from paddle_tpu_torch.utils import debug as tdebug

    jcost, tcost = small_mlp()
    jparams = paddle_tpu.parameters.create(jcost, seed=3)
    tparams = carry(jparams)
    jnet, tnet = paddle_tpu.CompiledNetwork(paddle_tpu.Topology([jcost])), TNet(TTopo([tcost]))
    jb, tb = batch_both(mlp_batch(mlp_samples(8, 3, classes=CLASSES, pixels=PIXELS)))
    trows = tdebug.profile_layers(tnet, tparams.params, tb, repeats=1)
    jrows = jdebug.profile_layers(jnet, jparams.params, jb, repeats=1)
    assert [r[:2] for r in trows] == [r[:2] for r in jrows]
    assert all(r[2] > 0 for r in trows)
    rows = [(name, typ, float(i + 1)) for i, (name, typ, _) in enumerate(jrows)]
    assert tdebug.format_layer_profile(rows) == jdebug.format_layer_profile(rows)
    ts = tdebug.gradient_stats(tnet, tparams.params, tb)
    js = jdebug.gradient_stats(jnet, jparams.params, jb)
    assert sorted(ts) == sorted(js)
    for k in js:
        assert abs(ts[k] - js[k]) <= 1e-5 * max(js[k], 1e-6), (k, ts[k], js[k])
