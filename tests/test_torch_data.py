"""The port's host data path, metrics, schedulers and logging against the
JAX package on the same numpy-seeded inputs: NIfTI round trips and
canonical reorientation (the native reader against the Python one),
``VQVAETransform`` volumes and traces bit for bit, subject discovery, the
loader's order and sharding, csv/tsv tables without pandas, the
conditioning helpers, the metrics (NCDHW against JAX's NDHWC), the
schedulers and the trace CSV byte for byte."""

import os
import shutil
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthanatomy_tpu.data import datasets as jds
from synthanatomy_tpu.data import nifti as jnifti
from synthanatomy_tpu.data import transforms as jtf
from synthanatomy_tpu.metrics import regression as jreg
from synthanatomy_tpu.metrics import ssim as jssim
from synthanatomy_tpu.train import logging as jlog
from synthanatomy_tpu.train import schedulers as jsched
from synthanatomy_tpu.utils import general as jgen
from synthanatomy_tpu_torch import metrics as tmetrics
from synthanatomy_tpu_torch.data import datasets as tds
from synthanatomy_tpu_torch.data import nifti as tnifti
from synthanatomy_tpu_torch.data import transforms as ttf
from synthanatomy_tpu_torch.train import logging as tlog
from synthanatomy_tpu_torch.train import schedulers as tsched
from synthanatomy_tpu_torch.utils import general as tgen

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# an oblique affine: closest_canonical flips and permutes axes
OBLIQUE = np.array([[0.0, 0.0, -1.2, 40.0],
                    [0.9, 0.1, 0.0, -20.0],
                    [0.0, -1.1, 0.0, 10.0],
                    [0.0, 0.0, 0.0, 1.0]])


def _volume(seed=0, shape=(9, 10, 11)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint8, np.float64])
@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
def test_nifti_round_trip_matches_jax(tmp_path, dtype, ext):
    vol = (_volume() * 50).astype(dtype)
    tp, jp = str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}")
    tnifti.save_nifti(tp, vol, OBLIQUE)
    jnifti.save_nifti(jp, vol, OBLIQUE)
    for canonical in (False, True):
        t = tnifti.load_nifti(tp, as_closest_canonical=canonical)
        j = jnifti.load_nifti(jp, as_closest_canonical=canonical)
        assert t.data.dtype == j.data.dtype
        np.testing.assert_array_equal(t.data, j.data)
        np.testing.assert_array_equal(t.affine, j.affine)
    t = tnifti.load_nifti(tp, as_closest_canonical=False)
    np.testing.assert_array_equal(t.data, vol.astype(t.data.dtype))
    tc, jc = tnifti.closest_canonical(t), jnifti.closest_canonical(
        jnifti.load_nifti(jp, as_closest_canonical=False))
    np.testing.assert_array_equal(tc.data, jc.data)
    np.testing.assert_array_equal(tc.affine, jc.affine)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_native_reader_matches_python_reader(tmp_path, canonical, normalize):
    from synthanatomy_tpu_torch import native

    if shutil.which("g++") is None or not native.native_available():
        pytest.skip("the native reader needs g++ and zlib")
    path = str(tmp_path / "v.nii.gz")
    tnifti.save_nifti(path, (_volume(1) * 100).astype(np.int16), OBLIQUE)
    vol, aff = native.load_nifti_native(path, normalize=normalize, canonical=canonical)
    ref = tnifti.load_nifti(path, as_closest_canonical=canonical)
    want = ttf.scale_intensity(ref.data) if normalize else ref.data.astype(np.float32)
    np.testing.assert_allclose(vol, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(aff, ref.affine, rtol=1e-6, atol=1e-5)
    # the library is built outside the package sources
    assert not list((tmp_path.parent).glob("libsat_nifti*.so"))
    assert native._library_path().startswith(native._BUILD_DIR)


TRANSFORMS = {
    "full": dict(augment=False),
    "roi-crop-pad": dict(roi=((1, 8), (0, 12), (2, 9)), augment=False),
    "center-roi": dict(roi=(6, 12, 7), augment=False),
    "patch": dict(patch_size=(4, 5, 6), augment=True, augmentation_probability=0.7),
    "augmented": dict(augment=True, augmentation_probability=1.0, augmentation_strength=0.5),
    "augmented-p": dict(augment=True, augmentation_probability=0.5),
    "extracting": dict(mode="extracting", augment=False, roi=(6, 12, 7)),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_vqvae_transform_is_bit_equal(name):
    kw = TRANSFORMS[name]
    vol = _volume(2)
    for seed in range(3):
        tv, tt = ttf.VQVAETransform(**kw)(vol, np.random.default_rng(seed))
        jv, jt = jtf.VQVAETransform(**kw)(vol, np.random.default_rng(seed))
        assert tv.dtype == jv.dtype and tv.shape == jv.shape
        np.testing.assert_array_equal(tv, jv)
        assert tt == jt


def _tree(tmp_path, n=5):
    d = tmp_path / "vols"
    d.mkdir()
    for i in range(n):
        tnifti.save_nifti(str(d / f"s{i}.nii.gz"), (_volume(10 + i, (8, 9, 7)) * 30).astype(np.int16),
                          OBLIQUE)
    return d


def test_discovery_and_path_tables_match_jax(tmp_path):
    d = _tree(tmp_path)
    paths = sorted(str(p) for p in d.iterdir())
    for sep, ext in ((",", ".csv"), ("\t", ".tsv")):
        table = tmp_path / f"list{ext}"
        table.write_text(sep.join(["path", "other"]) + "\n"
                         + "".join(f"{p}{sep}{i}\n" for i, p in enumerate(reversed(paths)))
                         + "\n")
        for mode, n_aug in (("training", 0), ("extracting", 2)):
            assert (tds.discover_subjects(str(table), mode=mode, no_augmented_extractions=n_aug)
                    == jds.discover_subjects(str(table), mode=mode,
                                             no_augmented_extractions=n_aug))
    for mode, n_aug in (("training", 0), ("extracting", 3)):
        assert (tds.discover_subjects(str(d), mode=mode, no_augmented_extractions=n_aug)
                == jds.discover_subjects(str(d), mode=mode, no_augmented_extractions=n_aug))
    lat = tmp_path / "lat"
    lat.mkdir()
    for i in range(3):
        np.save(lat / f"l{i}.npy", np.zeros((2, 2, 2), np.uint16))
    assert tds.discover_decoding_subjects(str(lat)) == jds.discover_decoding_subjects(str(lat))
    with pytest.raises(ValueError):
        tds.discover_subjects(str(lat))


def test_read_table_types_columns_as_pandas(tmp_path):
    import pandas as pd

    p = tmp_path / "t.csv"
    p.write_text("subject,age,score,sex,flag\n"
                 "a,31,0.5,F,x\n"
                 "b,,1.25,M,NA\n"
                 "c,47,2,,y\n"
                 "\n"
                 "d,52,nan,F,z\n")
    header, cols = tds.read_table(str(p))
    df = pd.read_csv(p)
    assert header == list(df.columns)
    for c in header:
        for got, want in zip(cols[c], df[c].tolist()):
            if pd.isna(want):
                assert tds.is_missing(got), (c, got)
            else:
                assert got == want and type(got) is type(want.item() if hasattr(want, "item")
                                                           else want), (c, got, want)


@pytest.mark.parametrize("ext", [".csv", ".tsv"])
def test_load_conditionings_matches_jax(tmp_path, ext):
    sep = "\t" if ext == ".tsv" else ","
    p = tmp_path / f"cond{ext}"
    rows = [["subject", "age", "sex", "site"], ["s0", "30", "F", "1"], ["s1", "", "M", "2"],
            ["s2", "41.5", "M", "1"], ["s4", "50", "F", "3"], ["s3", "30", "", "2"]]
    p.write_text("".join(sep.join(r) + "\n" for r in rows))
    names = [f"s{i}" for i in range(6)]
    for conds in (("age", "sex"), ("site",), ("sex", "site")):
        tv, tsz, tk = tds.load_conditionings(str(p), conds, names)
        jv, jsz, jk = jds.load_conditionings(str(p), conds, names)
        assert (tsz, tk) == (jsz, jk)
        assert {c: list(v) for c, v in tv.items()} == {c: list(v) for c, v in jv.items()}


@pytest.mark.parametrize("shards", [(0, 1), (0, 2), (1, 2), (2, 3)])
@pytest.mark.parametrize("train", [True, False])
def test_loader_order_and_sharding_match_jax(tmp_path, shards, train):
    """Training shards (drop_last) and one shard equal JAX's loader.  An
    evaluation shard differs on purpose: the port deals the subjects
    round-robin, each once, where JAX pads by wrapping; its samples are
    JAX's one-shard samples r, r + n, ..."""
    d = _tree(tmp_path, 7)
    kw = dict(augment=train, augmentation_probability=0.5)

    def batches(mod_ds, mod_tf, shard):
        subjects = mod_ds.discover_subjects(str(d))
        ds = mod_ds.VolumeDataset(subjects, mod_tf.VQVAETransform(**kw), seed=3, use_native=False)
        loader = mod_ds.PrefetchLoader(ds, 2, shuffle=train, drop_last=train, num_workers=2,
                                       prefetch=2, shard_id=shard[0], num_shards=shard[1],
                                       seed=3)
        return len(loader), [b for e in (0, 1) for b in loader.epoch(e)]

    def samples(bs):
        return [(p, t, m, a) for b in bs
                for p, t, m, a in zip(b["paths"], b["traces"], b["MRI"], b["affines"])]

    dealt = not train and shards[1] > 1
    (tn, tb), (jn, jb) = batches(tds, ttf, shards), batches(jds, jtf, (0, 1) if dealt else shards)
    if dealt:
        r, n = shards
        per_epoch = samples(jb[:jn])
        want = per_epoch[r::n] * 2
        assert tn == -(-len(per_epoch[r::n]) // 2) and len(tb) == 2 * tn
    else:
        assert tn == jn and len(tb) == len(jb)
        for t, j in zip(tb, jb):
            assert t["paths"] == j["paths"]
        want = samples(jb)
    got = samples(tb)
    assert len(got) == len(want)
    for (tp, tt, tm, ta), (jp, jt, jm, ja) in zip(got, want):
        assert tp == jp and tt == jt
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(ta, ja)


class _CountingDataset:
    """Counts the volumes loaded; ``get`` takes a little time, as a read does."""

    def __init__(self, n):
        self.n, self.loaded, self.lock = n, 0, threading.Lock()

    def __len__(self):
        return self.n

    def get(self, i, epoch=0):
        with self.lock:
            self.loaded += 1
        time.sleep(0.005)
        return {"MRI": np.full((2, 2, 2, 1), i, np.float32), "path": str(i)}


def _wait_for(pred, timeout=10.0):
    t0 = time.monotonic()
    while not pred() and time.monotonic() - t0 < timeout:
        time.sleep(0.01)


@pytest.mark.parametrize("prefetch", [1, 2, 4])
def test_loader_holds_at_most_prefetch_batches(prefetch):
    """A consumer that stalls holds the workers at ``prefetch`` batches
    ahead; closing the generator stops them."""
    ds = _CountingDataset(40)
    before = threading.active_count()
    loader = tds.PrefetchLoader(ds, 2, shuffle=False, drop_last=True, num_workers=8,
                                prefetch=prefetch)
    gen = loader.epoch(0)
    first = next(gen)
    assert first["paths"] == ["0", "1"]
    ahead = 2 * (1 + prefetch)  # the batch yielded and prefetch more
    _wait_for(lambda: ds.loaded >= ahead)
    time.sleep(0.2)  # the stalled consumer: no worker may take more
    assert ds.loaded == ahead
    second = next(gen)
    assert second["paths"] == ["2", "3"]
    _wait_for(lambda: ds.loaded >= ahead + 2)
    time.sleep(0.1)
    assert ds.loaded == ahead + 2
    gen.close()
    assert threading.active_count() == before  # the workers joined
    loaded = ds.loaded
    time.sleep(0.1)
    assert ds.loaded == loaded < len(ds)


def test_loader_error_stops_the_workers():
    class Failing(_CountingDataset):
        def get(self, i, epoch=0):
            if i == 4:
                raise ValueError("unreadable volume")
            return super().get(i, epoch)

    ds = Failing(40)
    before = threading.active_count()
    loader = tds.PrefetchLoader(ds, 2, shuffle=False, num_workers=4, prefetch=2)
    with pytest.raises(ValueError, match="unreadable"):
        for _ in loader.epoch(0):
            pass
    assert threading.active_count() == before
    assert ds.loaded <= 2 * (3 + 2)


def test_native_loader_feeds_the_same_batches(tmp_path):
    from synthanatomy_tpu_torch import native

    if shutil.which("g++") is None or not native.native_available():
        pytest.skip("the native reader needs g++ and zlib")
    d = _tree(tmp_path, 3)
    subjects = tds.discover_subjects(str(d))
    out = []
    for use_native in (False, True):
        ds = tds.VolumeDataset(subjects, ttf.VQVAETransform(augment=False), use_native=use_native)
        assert (ds._native is not None) == use_native
        out.append(np.stack([ds.get(i)["MRI"] for i in range(3)]))
    np.testing.assert_allclose(out[1], out[0], rtol=1e-6, atol=1e-6)


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=shape), 0, 1).astype(np.float32)
    return a, b


def _t(a):  # NDHWC → NCDHW
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


@pytest.mark.parametrize("shape", [(2, 48, 56, 50, 1), (1, 80, 64, 72, 1), (2, 20, 22, 18, 1)])
def test_metrics_match_jax(shape):
    a, b = _pair(5, shape)
    for tf, jf in ((tmetrics.mae, jreg.mae), (tmetrics.mse, jreg.mse)):
        np.testing.assert_allclose(float(tf(_t(a), _t(b))), float(jf(jnp.asarray(a),
                                                                      jnp.asarray(b))),
                                   rtol=1e-5, atol=1e-7)
    try:
        win = tmetrics.get_ms_ssim_window(input_shape=shape[1:4])
    except ValueError:  # too small for MS-SSIM: single-scale SSIM
        s = float(tmetrics.ssim_3d(_t(a), _t(b), win_size=5))
        np.testing.assert_allclose(s, float(jssim.ssim_3d(a, b, win_size=5)), atol=1e-5)
        return
    got = float(tmetrics.ms_ssim_3d(_t(a), _t(b), win_size=win))
    want = float(jssim.ms_ssim_3d(a, b, win_size=win))
    assert abs(got - want) <= 1e-5, (got, want)


@pytest.mark.parametrize("kw", [dict(input_shape=(160, 224, 160)), dict(input_shape=(48, 64, 50)),
                                dict(roi=((16, 176), (16, 240), (96, 256))),
                                dict(roi=(80, 96, 112)), dict(eval_patch_size=(64, 64, 70)),
                                dict(input_shape=(20, 20, 20))])
def test_ms_ssim_window_is_jax_rule(kw):
    def call(f):
        try:
            return f(**kw)
        except ValueError as e:
            return str(e)

    assert call(tmetrics.get_ms_ssim_window) == call(jssim.get_ms_ssim_window)


def test_schedulers_identical():
    for step in range(0, 120, 7):
        assert tsched.linear(0.5, 25, 50, 5.0, step) == jsched.linear(0.5, 25, 50, 5.0, step)
        assert tsched.exponential(1e-3, 0.99, step) == jsched.exponential(1e-3, 0.99, step)
        assert tsched.step(1.0, 0.5, 10, step) == jsched.step(1.0, 0.5, 10, step)
        assert (tsched.multistep(1.0, 0.1, [20, 60], step)
                == jsched.multistep(1.0, 0.1, [20, 60], step))
        assert (tsched.decay_warmup_step(0.5, 80, step)
                == jsched.decay_warmup_step(0.5, 80, step))
        assert (tsched.decay_warmup_linear(0.5, 80, step)
                == jsched.decay_warmup_linear(0.5, 80, step))
    assert tsched.get_gamma(3e-4, 100, 37) == jsched.get_gamma(3e-4, 100, 37)
    assert tsched.get_max_decay_epochs(37, 3) == jsched.get_max_decay_epochs(37, 3)


def test_trace_csv_is_byte_equal_to_pandas(tmp_path):
    rng = np.random.default_rng(0)
    names = ["RandAffined", "RandFlipd_0", "RandGaussianNoised"]
    traces = [None] + [{n: bool(rng.random() < 0.5) for n in names[: 1 + i % 3]}
                       for i in range(6)]
    traces[3] = {n: np.bool_(True) for n in names}
    paths = [f"/data/sub,{i}.nii.gz" if i == 2 else f"/data/s{i}.nii.gz" for i in range(7)]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    t = tlog.write_transform_trace_csv(str(tmp_path / "t"), traces, paths, rank=1)
    j = jlog.write_transform_trace_csv(str(tmp_path / "j"), traces, paths, rank=1)
    assert os.path.basename(t) == os.path.basename(j)
    assert open(t, "rb").read() == open(j, "rb").read()
    assert tlog.write_transform_trace_csv(str(tmp_path), [None], ["x"]) is None


def _cond_table(tmp_path):
    rng = np.random.default_rng(1)
    p = tmp_path / "cond.csv"
    lines = ["eid,age,bmi,sex"]
    for i in range(40):
        age = "" if i == 7 else f"{rng.uniform(40, 80):.2f}"
        lines.append(f"id{i},{age},{rng.uniform(18, 35):.1f},{i % 2}")
    p.write_text("\n".join(lines) + "\n")
    return p


def test_quantize_conditionings_matches_pandas(tmp_path):
    p = _cond_table(tmp_path)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    args = (str(p), "eid", ("age", "bmi"), (4, None))
    t = tgen.quantize_conditionings(*args, str(tmp_path / "t"), "q")
    j = jgen.quantize_conditionings(*args, str(tmp_path / "j"), "q")
    assert open(t, "rb").read() == open(j, "rb").read()


def test_uniform_sampling_matches_pandas(tmp_path):
    p = _cond_table(tmp_path)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    t = tgen.uniform_sampling(str(p), ("sex",), str(tmp_path / "t"))
    j = jgen.uniform_sampling(str(p), ("sex",), str(tmp_path / "j"))
    assert open(t, "rb").read() == open(j, "rb").read()


def test_save_npy_outputs_match_jax(tmp_path):
    arrs = np.random.default_rng(0).integers(0, 2048, (3, 2, 3, 2))
    srcs = ["/a/x.nii.gz", "/a/y.nii", "/a/z.npy"]
    t = tlog.save_npy_outputs(str(tmp_path / "t"), arrs, srcs, postfix="quantization_0",
                              augmentation_ids=[0, 2, 0])
    j = jlog.save_npy_outputs(str(tmp_path / "j"), arrs, srcs, postfix="quantization_0",
                              augmentation_ids=[0, 2, 0])
    assert [os.path.basename(p) for p in t] == [os.path.basename(p) for p in j]
    for a, b in zip(t, j):
        x, y = np.load(a), np.load(b)
        assert x.dtype == y.dtype == np.uint16
        np.testing.assert_array_equal(x, y)


def test_tb_logger_is_a_no_op_without_tensorboardx(tmp_path, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_tbx(name, *a, **k):
        if name == "tensorboardX":
            raise ImportError("no tensorboardX")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tbx)
    tb = tlog.TBLogger(str(tmp_path / "logs"))
    assert tb.writer is None
    tb.scalars({"a": 1.0}, 1)
    tb.volume_images("v", np.zeros((4, 4, 4)), 1)
    tb.close()


def test_gz_written_at_level_1_decodes_as_jax_level_9(tmp_path):
    """The port writes ``.nii.gz`` at gzip level 1 (nibabel's default; the
    gzip header's XFL byte says 4, "fastest"); the JAX copy at level 9
    (XFL 2).  Both decode to the same volume."""
    vol = (np.round(_volume(3, (20, 24, 18)) * 4) / 4).astype(np.float32)  # few values
    tnifti.save_nifti(str(tmp_path / "t.nii.gz"), vol, OBLIQUE)
    jnifti.save_nifti(str(tmp_path / "j.nii.gz"), vol, OBLIQUE)
    assert (tmp_path / "t.nii.gz").read_bytes()[8] == 4
    assert (tmp_path / "j.nii.gz").read_bytes()[8] == 2
    for load in (tnifti.load_nifti, jnifti.load_nifti):
        a = load(str(tmp_path / "t.nii.gz"), as_closest_canonical=False)
        b = load(str(tmp_path / "j.nii.gz"), as_closest_canonical=False)
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.affine, b.affine)
