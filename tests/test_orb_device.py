"""On-device ORB extraction (frontend/orb_device.py) vs the NumPy oracle.

Small image / few levels to keep the compile tractable in the suite; the
semantics checked are the ones shared with frontend/orb.py: FAST corners,
cell retry, orientation, and the SAME BRIEF pattern (co-located keypoints
must produce near-identical descriptors across backends)."""

import numpy as np
import pytest

from amcslam_tpu.frontend.orb import OrbPipeline
from amcslam_tpu.frontend.orb_device import ORBExtractorDevice


def _structured_image(rng, H, W):
    img = np.zeros((H, W), np.float64)
    for _ in range(40):
        y, x = rng.randint(15, H - 15), rng.randint(15, W - 15)
        s = rng.randint(3, 8)
        img[y - s: y + s, x - s: x + s] += rng.uniform(40, 120)
    return np.clip(img + rng.randn(H, W) * 3 + 40, 0, 255).astype(np.uint8)


@pytest.mark.slow
def test_orb_device_matches_numpy_semantics():
    rng = np.random.RandomState(0)
    H, W = 160, 200
    img = _structured_image(rng, H, W)

    ref = OrbPipeline(n_features=200, n_levels=3)
    xy_r, oc_r, de_r, an_r = ref.extract(img, force_python=True)
    assert len(xy_r) > 50

    ext = ORBExtractorDevice(n_features=200, n_levels=3)
    xy_t, oc_t, de_t, an_t = ext.extract(img)
    assert len(xy_t) > 50

    # a solid majority of oracle keypoints are co-located on-device (the
    # selection policies differ: quadtree vs cell-best + top-K)
    matched = 0
    hamm = []
    for lv in range(3):
        a, b = xy_r[oc_r == lv], xy_t[oc_t == lv]
        da, db = de_r[oc_r == lv], de_t[oc_t == lv]
        if len(a) == 0 or len(b) == 0:
            continue
        d2 = np.sum((a[:, None, :] - b[None, :, :]) ** 2, -1)
        j = np.argmin(d2, axis=1)
        hit = d2[np.arange(len(a)), j] < 1.5 ** 2
        matched += int(hit.sum())
        for i in np.where(hit)[0]:
            hamm.append(np.unpackbits(da[i] ^ db[j[i]]).sum())
    assert matched >= 0.5 * len(xy_r), (matched, len(xy_r))
    # descriptors of co-located keypoints agree almost bit-for-bit (same
    # BRIEF pattern, same blur, same orientation formula)
    assert np.median(hamm) <= 8, np.median(hamm)


@pytest.mark.slow
def test_build_frame_device_backend_single_dispatch():
    """make_extractors(backend='device') + build_frame: the whole rig extracts
    through the batched on-device path (one extract_batch call) and yields a
    Frame with populated per-camera features and stereo depth."""
    from amcslam_tpu.frontend.features import build_frame, make_extractors
    from amcslam_tpu.pipeline.rig import Rig

    rng = np.random.RandomState(1)
    H, W = 120, 160
    imgs = [_structured_image(rng, H, W) for _ in range(3)]
    # stereo right = left shifted 4 px (disparity) so row matching succeeds
    img_r = np.roll(imgs[-1], -4, axis=1)

    K = np.array([100.0, 100.0, W / 2, H / 2])
    rig = Rig(Tbc=np.stack([np.eye(4)] * 3), K=np.stack([K] * 3), bf=40.0)

    exts = make_extractors(3, n_features=150, backend="device", n_levels=2)
    calls = {"n": 0}
    orig = exts[-1].extract_batch

    def counting(images):
        calls["n"] += 1
        return orig(images)

    exts[-1].extract_batch = counting
    frame = build_frame(imgs, np.array([0.0, 0.01, 0.02]), rig, exts,
                        right_image=img_r)
    assert calls["n"] == 1, "rig must extract in one batched dispatch"
    assert all(len(frame.keypoints[c]) > 20 for c in range(3))
    assert frame.kp_depth is not None and (frame.kp_depth > 0).sum() > 5
