"""The port's ingest (tpu_splat_torch/ingest/video.py and blur.py) against
the JAX package's on seeded media: decoded frames, loaded images, archive
contents, EXIF focal and alpha compositing equal; Laplacian-variance scores
within 1e-6 relative, saliency-masked scores within 1e-4 relative, and the
selected frame indices equal."""

import os
import zipfile

import numpy as np
import pytest

from tpu_splat.core.errors import PipelineError as JPipelineError
from tpu_splat.ingest import blur as jblur
from tpu_splat.ingest import video as jvideo
from tpu_splat_torch.core.errors import PipelineError as TPipelineError
from tpu_splat_torch.ingest import blur as tblur
from tpu_splat_torch.ingest import video as tvideo

W, H = 64, 48


def seeded_frames(n=12, seed=0):
    """Smooth seeded frames (uint8 RGB) in which every third one is blurred."""
    import cv2

    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (n, H // 4, W // 4, 3)).astype(np.float32)
    frames = np.stack([cv2.resize(b, (W, H), interpolation=cv2.INTER_CUBIC) for b in base])
    frames += rng.normal(0, 12, frames.shape)
    for i in range(0, n, 3):
        frames[i] = cv2.GaussianBlur(frames[i], (0, 0), 2.0)
    return np.clip(frames, 0, 255).astype(np.uint8)


def test_extract_frames_matches_reference(tmp_path):
    import cv2

    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (W, H))
    assert writer.isOpened()
    for f in seeded_frames(20):
        writer.write(np.ascontiguousarray(f[..., ::-1]))
    writer.release()
    for kw in (dict(max_frames=7), dict(max_frames=60, resize_max_dim=32)):
        got, want = tvideo.extract_frames(path, **kw), jvideo.extract_frames(path, **kw)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert tvideo.VIDEO_EXTENSIONS == jvideo.VIDEO_EXTENSIONS
    assert tvideo.IMAGE_EXTENSIONS == jvideo.IMAGE_EXTENSIONS
    with pytest.raises(IOError):
        tvideo.extract_frames(str(tmp_path / "missing.avi"))


def test_images_zip_exif_and_alpha_match_reference(tmp_path):
    import cv2
    from PIL import Image

    frames = seeded_frames(4)
    src = tmp_path / "src"
    src.mkdir()
    for i, f in enumerate(frames):
        cv2.imwrite(str(src / f"f_{i}.png"), f[..., ::-1])
    # an RGBA frame, a frame of another size, and files that are not frames
    rgba = np.concatenate([frames[0], np.linspace(0, 255, W * H).reshape(H, W, 1)], -1)
    cv2.imwrite(str(src / "f_9_alpha.png"), rgba.astype(np.uint8)[..., [2, 1, 0, 3]])
    cv2.imwrite(str(src / "f_8_big.png"), cv2.resize(frames[1], (2 * W, 2 * H)))
    (src / "notes.txt").write_text("not an image")
    for kw in (dict(), dict(resize_max_dim=40, limit=3)):
        (got, gn), (want, wn) = (tvideo.load_images_from_dir(str(src), **kw),
                                 jvideo.load_images_from_dir(str(src), **kw))
        assert gn == wn
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tvideo.composite_alpha(rgba.astype(np.uint8), bg=30),
                                  jvideo.composite_alpha(rgba.astype(np.uint8), bg=30))
    np.testing.assert_array_equal(tvideo.resize_to_max_dim(frames[0], 20),
                                  jvideo.resize_to_max_dim(frames[0], 20))

    zpath = str(tmp_path / "capture.zip")
    with zipfile.ZipFile(zpath, "w") as zf:
        for name in sorted(os.listdir(src)):
            zf.write(src / name, f"capture/{name}")
        zf.writestr("capture/depth/d_0.png", (src / "f_0.png").read_bytes())
        zf.writestr("capture/masks/f_0.png", (src / "f_0.png").read_bytes())
        zf.writestr("capture/transforms.json", "{}")
        zf.writestr("capture/sparse/0/cameras.txt", "# none\n")
        zf.writestr("__MACOSX/._f_0.png", b"junk")
    got = tvideo.extract_zip(zpath, str(tmp_path / "port"))
    want = jvideo.extract_zip(zpath, str(tmp_path / "ref"))
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == \
        [os.path.relpath(p, tmp_path / "ref") for p in want]

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)
    assert tree(tmp_path / "port") == tree(tmp_path / "ref")
    empty = str(tmp_path / "empty.zip")
    with zipfile.ZipFile(empty, "w") as zf:
        zf.writestr("readme.txt", "no frames")
    with pytest.raises(TPipelineError) as e:
        tvideo.extract_zip(empty, str(tmp_path / "e_port"))
    with pytest.raises(JPipelineError) as e_ref:
        jvideo.extract_zip(empty, str(tmp_path / "e_ref"))
    assert e.value.code == e_ref.value.code == 790 and str(e.value) == str(e_ref.value)

    jpg = str(tmp_path / "exif.jpg")
    exif = Image.Exif()
    exif.get_ifd(0x8769)[0xA405] = 26  # FocalLengthIn35mmFilm
    Image.fromarray(frames[0]).save(jpg, exif=exif)
    plain = str(tmp_path / "plain.jpg")
    Image.fromarray(frames[1]).save(plain)
    for path in (jpg, plain, str(src / "notes.txt")):
        assert tvideo.exif_focal_px(path, W) == jvideo.exif_focal_px(path, W)
    assert tvideo.exif_focal_px(jpg, W) == pytest.approx(W * 26 / 36.0)


def test_blur_scores_and_selection_match_reference():
    frames = seeded_frames(12, seed=1).astype(np.float32) / 255.0
    for imgs in (frames, frames[..., 0]):
        got, want = tblur.laplacian_variance(imgs), jblur.laplacian_variance(imgs)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    scores = tblur.laplacian_variance(frames)
    assert scores[0] < scores[1]  # the blurred frames score lower
    for target in (3, 5, 8, 12):
        np.testing.assert_array_equal(tblur.select_sharp_frames(scores, target),
                                      jblur.select_sharp_frames(scores, target))
    np.testing.assert_array_equal(tblur.select_sharp_frames(scores, 4, 2, 5),
                                  jblur.select_sharp_frames(scores, 4, 2, 5))
    np.testing.assert_array_equal(tblur.reduce_equidistant(np.arange(3, 20, 2), 4),
                                  jblur.reduce_equidistant(np.arange(3, 20, 2), 4))
    for kw in (dict(target_count=6), dict(), dict(target_count=5, mask_method="center")):
        (gi, gx), (wi, wx) = (tblur.filter_blurry_images(frames, **kw),
                              jblur.filter_blurry_images(frames, **kw))
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("weights", ["matnet", "classical"])
def test_saliency_blur_scores_match_reference(weights, monkeypatch):
    """Saliency-masked scores from MatNet's masks, and from the classical
    saliency when no MatNet weights are found (with the copied uint8 quirk),
    Farneback-warped and filtered through time on the host."""
    from tpu_splat.matting import matnet as jmatnet
    from tpu_splat_torch.matting import matnet as tmatnet

    if weights == "classical":
        monkeypatch.setattr(jmatnet, "bundled_weights_path", lambda: None)
        monkeypatch.setattr(tmatnet, "bundled_weights_path", lambda: None)
    frames = seeded_frames(8, seed=2).astype(np.float32) / 255.0
    got = tblur.saliency_laplacian_variance(frames, decay_frames=2.0, device="cpu")
    want = jblur.saliency_laplacian_variance(frames, decay_frames=2.0)
    assert got.shape == (8,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def test_saliency_blur_filter_selects_reference_frames():
    frames = seeded_frames(8, seed=3).astype(np.float32) / 255.0
    (gi, gx), (wi, wx) = (
        tblur.filter_blurry_images(frames, target_count=4, mask_method="u2net", device="cpu"),
        jblur.filter_blurry_images(frames, target_count=4, mask_method="u2net"))
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gi, wi)
