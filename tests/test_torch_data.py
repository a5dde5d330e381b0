"""The port's data layer against the JAX package's, on the CPU: the
synthetic generator, calibration parsing, the image codec and transforms,
WildtrackDataset, collate, the splits and the Prefetcher.

Trees are written at 108x192 with 3 views by both generators from one
seed; the readers work at 54x96 (the codec's triangle resize halves each
side). Images are compared bit for bit (uint8), calibrations and
annotations exactly, the float32 normalised images to 1 ulp.
"""

import json
import time

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from vsta_tpu import config as jcfg
from vsta_tpu import native as jnative
from vsta_tpu.data import calibration as jcal
from vsta_tpu.data import pipeline as jpipe
from vsta_tpu.data import synthetic as jsyn
from vsta_tpu.data import transforms as jtf
from vsta_tpu.data import wildtrack as jwt
from vsta_tpu_torch import config as tcfg
from vsta_tpu_torch import native as tnative
from vsta_tpu_torch.data import calibration as tcal
from vsta_tpu_torch.data import pipeline as tpipe
from vsta_tpu_torch.data import synthetic as tsyn
from vsta_tpu_torch.data import transforms as ttf
from vsta_tpu_torch.data import wildtrack as twt

from test_torch_jax_cache import jax_reference_private_cache  # noqa: F401  (autouse: no shared cache)


TREE_HW = (108, 192)
VIEWS = 3
N_FRAMES = 5
LAYOUTS = ["persons", "world-pos", "position-id"]


def _write_position_ids(root):
    """The official layout's positionID on every person of every frame."""
    for i, p in enumerate(sorted((root / "annotations_positions").iterdir())):
        persons = json.loads(p.read_text())
        for person in persons:
            person["positionID"] = 480 * (100 + 40 * i + person["personID"]) + 7 * person["personID"] + i
        p.write_text(json.dumps(persons))


@pytest.fixture(scope="module", params=LAYOUTS)
def trees(request, tmp_path_factory):
    """(layout, JAX tree, port tree), written by each package's generator."""
    base = tmp_path_factory.mktemp(request.param)
    kw = dict(n_frames=N_FRAMES, n_views=VIEWS, n_people=4, img_hw=TREE_HW,
              world_pos_format=request.param == "world-pos", seed=1)
    j = jsyn.generate_synthetic_wildtrack(base / "jax", **kw)
    t = tsyn.generate_synthetic_wildtrack(base / "port", **kw)
    if request.param == "position-id":
        _write_position_ids(j)
        _write_position_ids(t)
    return request.param, j, t


def _raw(root, **data):
    return {
        "DATA": {"BATCH_SIZE": 2, "IMG_SIZE": [3, 54, 96], "VIEWS": VIEWS, "DATA_ROOT": str(root), **data},
        "MODEL": {"BEV_SIZE": [32, 12, 24], "BEV_BOUNDS": [-12.0, 12.0, -6.0, 6.0]},
        "TRAIN": {"SEED": 5},
        "LOSS": {"MAX_OBJECTS": 8},
    }


def _datasets(root, train, **data):
    raw = _raw(root, **data)
    return jwt.WildtrackDataset(jcfg.from_dict(raw), train=train), twt.WildtrackDataset(tcfg.from_dict(raw), train=train)


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_generator_writes_the_same_tree(trees):
    layout, j, t = trees
    assert _files(j) == _files(t)
    for rel in _files(j):
        a, b = j / rel, t / rel
        if rel.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(b)), np.asarray(Image.open(a)), err_msg=rel)
        elif rel.endswith(".json"):
            assert json.loads(b.read_text()) == json.loads(a.read_text()), rel
        else:
            assert b.read_text() == a.read_text(), rel
            K_j, Rt_j = jcal.load_camera_xml(a)
            K_t, Rt_t = tcal.load_camera_xml(b)
            np.testing.assert_array_equal(K_t, K_j, err_msg=rel)
            np.testing.assert_array_equal(Rt_t, Rt_j, err_msg=rel)
    assert len(_files(j)) == VIEWS * (N_FRAMES + 2) + N_FRAMES


def test_calibrations_rescale_and_ground_projection_match(trees):
    _, j, _ = trees
    Ks_j, Rts_j = jcal.load_wildtrack_calibrations(j / "Calibration", VIEWS)
    Ks_t, Rts_t = tcal.load_wildtrack_calibrations(j / "Calibration", VIEWS)
    for a, b in zip(Ks_j + Rts_j, Ks_t + Rts_t):
        np.testing.assert_array_equal(b, a)
    assert abs(np.linalg.norm(Rts_t[0][:3, 3]) - 20.88) < 0.01  # millimetres became metres
    for K, Rt in zip(Ks_j, Rts_j):
        np.testing.assert_array_equal(
            tcal.rescale_intrinsics(K, TREE_HW, (54, 96)), jcal.rescale_intrinsics(K, TREE_HW, (54, 96))
        )
        for u, v in ((96.0, 80.0), (10.5, 107.0), (96.0, 1.0)):
            assert tcal.pixel_to_world_np(u, v, K, Rt) == jcal.pixel_to_world_np(u, v, K, Rt)
    rv = np.array([0.3, -1.1, 0.4])
    np.testing.assert_array_equal(tcal.rodrigues_np(rv), jcal.rodrigues_np(rv))
    assert tcal.parse_float_list("1, 2;3\n x 4e-1") == jcal.parse_float_list("1, 2;3\n x 4e-1")


@pytest.fixture
def codec_off(monkeypatch):
    """Both packages' native codecs switched off: the port's through its
    environment switch, the JAX package's (which reads its own switch once
    a process) through its module state."""
    monkeypatch.setenv(tnative.OFF_SWITCH, "1")
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)


@pytest.mark.parametrize("decoder", ["native", "pil"])
def test_decode_resize_u8_bit_equal(trees, decoder, request):
    _, j, _ = trees
    if decoder == "pil":
        request.getfixturevalue("codec_off")
    assert tnative.available() == jnative.available() == (decoder == "native")
    for png in sorted((j / "Image_subsets").rglob("*.png"))[:4]:
        for hw in ((54, 96), (41, 77), TREE_HW):
            got, path = ttf.decode_u8(str(png), hw)
            assert path == decoder
            np.testing.assert_array_equal(got, jtf.decode_resize_u8(str(png), hw))
            np.testing.assert_array_equal(ttf.decode_resize_u8(str(png), hw), got)
    norm_j = jtf.load_and_transform(str(png), (54, 96))
    np.testing.assert_array_max_ulp(ttf.load_and_transform(str(png), (54, 96)), norm_j, maxulp=1)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_jitter_and_transforms_bit_equal(trees, seed):
    _, j, _ = trees
    png = sorted((j / "Image_subsets").rglob("*.png"))[seed]
    u8 = jtf.decode_resize_u8(str(png), (54, 96))
    img = Image.fromarray(u8, "RGB")
    got = ttf.color_jitter(img, np.random.default_rng(seed))
    want = jtf.color_jitter(img, np.random.default_rng(seed))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for train in (True, False):
        r_t, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(ttf.jitter_u8(u8, r_t, train), jtf.jitter_u8(u8, r_j, train))
        np.testing.assert_array_max_ulp(ttf.transform_u8(u8, r_t, train), jtf.transform_u8(u8, r_j, train), maxulp=1)
        assert r_t.uniform() == r_j.uniform()  # both drew the same numbers
        np.testing.assert_array_max_ulp(
            ttf.load_and_transform(str(png), (54, 96), np.random.default_rng(seed), train),
            jtf.load_and_transform(str(png), (54, 96), np.random.default_rng(seed), train), maxulp=1,
        )


def _same_sample(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what}: {k}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_dataset_samples_match(trees, train):
    layout, j, _ = trees
    jds, tds = _datasets(j, train, USE_POSITION_ID=layout == "position-id")
    assert tds.frame_files == jds.frame_files and tds.orig_hw == jds.orig_hw == TREE_HW
    np.testing.assert_array_equal(tds.Ks, jds.Ks)
    np.testing.assert_array_equal(tds.Rts, jds.Rts)
    for c_t, c_j, i_t, i_j in zip(tds.centers_per_frame, jds.centers_per_frame, tds.ids_per_frame, jds.ids_per_frame):
        np.testing.assert_array_equal(c_t, c_j)
        np.testing.assert_array_equal(i_t, i_j)
    assert sum(len(c) for c in tds.centers_per_frame) > 0
    if layout == "position-id":
        np.testing.assert_allclose(tds.centers_per_frame[0][0], twt.position_id_to_world(480 * 100))
    for epoch in (0, 3):
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        for i in range(len(jds)):
            _same_sample(tds[i], jds[i], f"{layout} epoch {epoch} frame {i}")
    assert tds.decoders == {"native" if tnative.available() else "pil"}
    if train:  # the jitter moves with the epoch
        tds.set_epoch(0)
        first = [tds[i]["images"] for i in range(len(tds))]
        tds.set_epoch(1)
        assert any(not np.array_equal(tds[i]["images"], first[i]) for i in range(len(tds)))


def test_dataset_shares_its_cache_and_reads_floats_when_asked(trees):
    _, j, _ = trees
    raw = _raw(j)
    train_ds = twt.WildtrackDataset(tcfg.from_dict(raw), train=True)
    eval_ds = twt.WildtrackDataset(tcfg.from_dict(raw), train=False, cache_from=train_ds)
    assert eval_ds._cache is train_ds._cache and eval_ds.decoders is train_ds.decoders
    train_ds[1]
    assert (0, 1) in eval_ds._cache
    jds, tds = _datasets(j, True, DEVICE_NORMALIZE=False)
    got, want = tds[2], jds[2]
    assert got["images"].dtype == np.float32
    np.testing.assert_array_max_ulp(got["images"], want["images"], maxulp=1)


def test_collate_splits_and_clip_plans_match(trees):
    _, j, _ = trees
    jds, tds = _datasets(j, False)
    _same_sample(tpipe.collate([tds[i] for i in (3, 1, 1)]), jwt.collate([jds[i] for i in (3, 1, 1)]), "collate")
    for n in (1, 2, 4, 5, 10, 499, 500, 620):
        for seed in (0, 7):
            assert tpipe.split_train_val(n, seed) == jpipe.split_train_val(n, seed), (n, seed)
    assert tpipe.split_train_val(4, 0)[1] and len(tpipe.split_train_val(4, 0)[1]) == 1
    for n, clips in ((5, 2), (7, 3), (6, 6), (4, 1)):
        assert tpipe.multi_clip_plan(range(n), clips) == jpipe.multi_clip_plan(range(n), clips)
    with pytest.raises(ValueError):
        tpipe.multi_clip_plan(range(3), 4)


PREFETCH_CASES = {
    "unshuffled": dict(batch_size=2),
    "shuffled": dict(batch_size=2, shuffle=True, seed=3),
    "drop_last": dict(batch_size=2, shuffle=True, seed=1, drop_last=True),
    "plan": dict(batch_size=2, plan=jpipe.multi_clip_plan(range(N_FRAMES), 2)),
    "h2d_streams": dict(batch_size=3, h2d_streams=2),
}


@pytest.mark.parametrize("case", list(PREFETCH_CASES))
def test_cpu_prefetcher_yields_the_jax_batches(trees, case):
    """Two epochs of train-mode batches (the jitter follows the epoch that
    the Prefetcher sets on the dataset), in the same order and with the
    same batch_mask, from the port's Prefetcher on device "cpu" and from
    the JAX one (numpy batches; with h2d_streams, device_put and the
    on-device join). The h2d case reads float32 frames at the tree's
    size, so the images leaf (1.5 MB) is split into two pieces."""
    _, j, _ = trees
    kw = dict(PREFETCH_CASES[case])
    data = {"DEVICE_NORMALIZE": False, "IMG_SIZE": [3, *TREE_HW]} if case == "h2d_streams" else {}
    jds, tds = _datasets(j, True, **data)
    jkw = dict(kw, device_put=jax.device_put) if case == "h2d_streams" else kw
    jpf = jpipe.Prefetcher(jds, range(N_FRAMES), num_workers=2, **jkw)
    tpf = tpipe.Prefetcher(tds, range(N_FRAMES), num_workers=2, device="cpu", **kw)
    assert len(tpf) == len(jpf)
    for epoch in range(2):
        want = [{k: np.asarray(v) for k, v in b.items()} for b in jpf]
        got = list(tpf)
        assert len(got) == len(want) == len(jpf)
        for i, (g, w) in enumerate(zip(got, want)):
            assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in g.values())
            _same_sample({k: v.numpy() for k, v in g.items()}, w, f"epoch {epoch} batch {i}")
        assert tpf.n_yielded == len(got) and tpf.wait_s >= 0.0
    if case == "unshuffled":
        assert got[-1]["batch_mask"].tolist() == [True, False]
    if case == "h2d_streams":
        assert tpipe.CHUNK_MIN_BYTES <= got[0]["images"].numel() * 4
    if case == "drop_last":
        assert len(got) == N_FRAMES // 2 and all(b["batch_mask"].all() for b in got)


def test_piece_bounds_are_array_split():
    for n in (0, 1, 7, 1024, 1025):
        for k in (1, 2, 3, 8):
            got = tpipe.piece_bounds(n, k)
            assert [b - a for a, b in got] == [len(x) for x in np.array_split(np.arange(n), k)]
            assert got[0][0] == 0 and got[-1][1] == n and all(p[1] == q[0] for p, q in zip(got, got[1:]))


def test_prefetcher_reraises_the_producers_exception(trees):
    _, j, _ = trees
    _, tds = _datasets(j, False)

    class Broken:
        def __len__(self):
            return len(tds)

        def __getitem__(self, i):
            if i == 3:
                raise ValueError("frame 3 is unreadable")
            return tds[i]

    pf = tpipe.Prefetcher(Broken(), range(N_FRAMES), batch_size=2, num_workers=1, device="cpu")
    with pytest.raises(RuntimeError, match="producer thread failed") as ei:
        list(pf)
    assert "unreadable" in str(ei.value.__cause__)


def test_prefetcher_early_break_stops_the_producer(trees):
    _, j, _ = trees
    _, tds = _datasets(j, False)
    seen = []
    pf = tpipe.Prefetcher(tds, range(N_FRAMES), batch_size=1, prefetch=1, num_workers=1, device="cpu")
    for b in pf:
        seen.append(b)
        break
    pf._last_producer.join(timeout=10.0)
    assert not pf._last_producer.is_alive(), "producer thread leaked after an early break"
    assert len(seen) == 1


def test_prefetcher_counts_the_consumers_wait():
    class Slow:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            time.sleep(0.05)
            return {"images": np.zeros((1, 2, 2, 3), np.uint8), "K": np.eye(3), "Rt": np.eye(4),
                    "boxes_world": np.zeros((1, 4)), "num_boxes": np.int32(0), "frame_idx": np.int32(i)}

    pf = tpipe.Prefetcher(Slow(), range(4), batch_size=1, num_workers=1, device="cpu")
    assert len(list(pf)) == 4 and pf.n_yielded == 4
    assert 0.1 < pf.wait_s < 10.0
