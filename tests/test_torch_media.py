"""The port's media and native I/O (vokselis_torch.media, vokselis_torch.
native, volume.io.load_raw): mirrors tests/test_media.py (PNG codec,
recorder worker, dimension math) and tests/test_video.py (a fake ffmpeg on
PATH that drains stdin to a file, for both recorder backends).

The native library is built from the repository's native/vokselis_native.cpp
with this machine's g++ into a ``tmp_path`` build directory (the package's
``BUILD_DIR`` is pointed there for the module): its PNG bytes and its raw
loads must equal the pure-Python paths' and the JAX package's
(``vokselis_tpu.media.png``, ``vokselis_tpu.volume.io.load_raw``) byte for
byte. Without g++, the native backend raises and "auto" takes the Python
paths.
"""

import os
import stat
import time

import numpy as np
import pytest

from vokselis_torch import native
from vokselis_torch.media.png import encode_png, read_png, write_png
from vokselis_torch.media.recorder import Recorder
from vokselis_torch.utils.misc import ContinuousDict, ImageDimensions
from vokselis_torch.volume.io import load_raw

FAKE_FFMPEG = """#!/bin/sh
# fake ffmpeg: last arg is the output path; drain stdin into <out>.raw
for out; do :; done
cat > "$out.raw"
"""


@pytest.fixture(scope="module")
def native_dir(tmp_path_factory):
    """The native library, built here into a build directory of this test
    module; BUILD_DIR points there while the module runs."""
    build = tmp_path_factory.mktemp("native_build")
    saved = native.BUILD_DIR
    native.BUILD_DIR = build
    try:
        native.get_lib()
        yield build
    finally:
        native.BUILD_DIR = saved


@pytest.fixture
def fake_ffmpeg(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    ff = bindir / "ffmpeg"
    ff.write_text(FAKE_FFMPEG)
    ff.chmod(ff.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    monkeypatch.chdir(tmp_path)
    return bindir


class TestPng:
    def test_roundtrip_rgba(self, tmp_path):
        img = np.random.default_rng(1).integers(0, 255, (31, 17, 4), dtype=np.uint8)
        p = str(tmp_path / "t.png")
        write_png(p, img)
        np.testing.assert_array_equal(img, read_png(p))

    def test_roundtrip_rgb_and_grey(self, tmp_path):
        for shape in [(8, 8, 3), (8, 8)]:
            img = np.random.default_rng(2).integers(0, 255, shape, dtype=np.uint8)
            p = str(tmp_path / "t.png")
            write_png(p, img)
            back = read_png(p)
            np.testing.assert_array_equal(img.reshape(back.shape), back)

    def test_signature(self):
        data = encode_png(np.zeros((2, 2, 4), np.uint8))
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        assert b"IHDR" in data and b"IDAT" in data and b"IEND" in data

    def test_reads_the_goldens(self):
        """Decode a committed golden (a PNG another encoder wrote)."""
        img = read_png(os.path.join(os.path.dirname(__file__), "goldens", "xor.png"))
        assert img.ndim == 3 and img.shape[2] in (3, 4)
        assert img.shape[0] >= 90


class TestRecorder:
    @pytest.mark.parametrize("backend", ["python", "native"])
    def test_screenshot_worker(self, tmp_path, monkeypatch, native_dir, backend):
        monkeypatch.chdir(tmp_path)
        rec = Recorder(backend=backend)
        assert rec.backend == backend
        frame = np.random.default_rng(0).integers(0, 255, (16, 16, 4), dtype=np.uint8)
        rec.screenshot(frame)
        rec.close()
        shots = os.listdir("screenshots")
        assert len(shots) == 1
        np.testing.assert_array_equal(frame, read_png(os.path.join("screenshots", shots[0])))

    def test_video_degrades_without_ffmpeg(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        monkeypatch.setenv("PATH", "")  # hide ffmpeg if any
        rec = Recorder(backend="python")
        assert not rec.ffmpeg_installed
        rec.start(ImageDimensions.new(16, 16))
        assert not rec.is_recording  # start is a no-op without ffmpeg
        rec.close()


class TestUtils:
    def test_image_dimensions_even_and_padded(self):
        d = ImageDimensions.new(1281, 721)
        assert d.width == 1280 and d.height == 720
        assert d.unpadded_bytes_per_row == 1280 * 4
        assert d.padded_bytes_per_row % 256 == 0
        assert d.linear_size() == d.padded_bytes_per_row * 720

    def test_image_dimensions_aligned_case(self):
        assert ImageDimensions.new(64, 64).padded_bytes_per_row == 64 * 4

    def test_continuous_dict(self):
        m = ContinuousDict()
        m.push_value("a", 1)
        m.push_value("a", 2)
        m.push_value("b", 3)
        assert m["a"] == [1, 2] and m["b"] == [3]


class TestNative:
    def test_builds_into_its_directory(self, native_dir):
        """Hashed by source and flags, in the given build directory, never
        in the JAX package's."""
        so = native.library_path()
        assert so.parent == native_dir and so.is_file()
        assert so.name.startswith("libvokselis_native_") and so.suffix == ".so"
        assert native.available() and native.get_lib() is native.get_lib()

    @pytest.mark.parametrize("shape", [(31, 17, 4), (9, 12, 3), (8, 8)])
    def test_png_bytes_equal_python(self, tmp_path, native_dir, shape):
        img = np.random.default_rng(4).integers(0, 255, shape, dtype=np.uint8)
        write_png(str(tmp_path / "n.png"), img, backend="native")
        write_png(str(tmp_path / "p.png"), img, backend="python")
        assert (tmp_path / "n.png").read_bytes() == (tmp_path / "p.png").read_bytes()
        assert (tmp_path / "p.png").read_bytes() == encode_png(img)
        np.testing.assert_array_equal(read_png(str(tmp_path / "n.png")).reshape(img.shape), img)

    def test_raw_load_equals_python(self, tmp_path, native_dir):
        vol = np.random.default_rng(5).integers(0, 255, (6, 5, 4), dtype=np.uint8)
        path = str(tmp_path / "v.raw")
        vol.tofile(path)
        nat = load_raw(path, dims=vol.shape, backend="native")
        np.testing.assert_array_equal(nat, load_raw(path, dims=vol.shape, backend="python"))
        np.testing.assert_array_equal(nat, vol)
        wide = np.arange(60, dtype=np.uint16).reshape(3, 4, 5)
        wide.tofile(path)
        np.testing.assert_array_equal(load_raw(path, (3, 4, 5), np.uint16, "native"), wide)
        with pytest.raises(ValueError, match="size"):
            load_raw(path, dims=(2, 2, 2), backend="native")

    @pytest.mark.parametrize("shape", [(31, 17, 4), (9, 12, 3), (8, 8)])
    def test_png_bytes_equal_jax(self, tmp_path, native_dir, shape):
        """The port's native PNG bytes equal the JAX package's encoder's and
        its write_png's (its own native library where that builds)."""
        jpng = pytest.importorskip("vokselis_tpu.media.png")
        img = np.random.default_rng(7).integers(0, 255, shape, dtype=np.uint8)
        write_png(str(tmp_path / "n.png"), img, backend="native")
        jpng.write_png(str(tmp_path / "j.png"), img)
        assert (tmp_path / "n.png").read_bytes() == jpng.encode_png(img)
        assert (tmp_path / "n.png").read_bytes() == (tmp_path / "j.png").read_bytes()

    @pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
    def test_raw_load_equals_jax(self, tmp_path, native_dir, dtype):
        """The port's native and Python raw loads equal the JAX package's
        load_raw on the same seeded volume."""
        jio = pytest.importorskip("vokselis_tpu.volume.io")
        vol = np.random.default_rng(8).integers(0, 255, (7, 6, 5)).astype(dtype)
        path = str(tmp_path / "v.raw")
        vol.tofile(path)
        ref = jio.load_raw(path, dims=vol.shape, dtype=dtype)
        for backend in ("native", "python"):
            got = load_raw(path, vol.shape, dtype, backend)
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)

    def test_native_recorder_screenshot(self, tmp_path, native_dir):
        frame = np.random.default_rng(6).integers(0, 255, (10, 14, 4), dtype=np.uint8)
        rec = native.NativeRecorder()
        rec.screenshot(str(tmp_path / "s.png"), frame)
        rec.close()
        np.testing.assert_array_equal(read_png(str(tmp_path / "s.png")), frame)

    def test_without_gpp_native_raises_and_auto_is_python(self, tmp_path, monkeypatch):
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "empty")
        monkeypatch.setattr(native, "_probe", {})
        monkeypatch.setenv("PATH", "")
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            Recorder(backend="native")
        rec = Recorder(backend="auto")
        assert rec.backend == "python"
        rec.close()
        img = np.zeros((4, 4, 3), np.uint8)
        write_png(str(tmp_path / "a.png"), img)
        assert (tmp_path / "a.png").read_bytes() == encode_png(img)
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            write_png(str(tmp_path / "n.png"), img, backend="native")
        with pytest.raises(ValueError, match="backend"):
            Recorder(backend="rust")


@pytest.mark.parametrize("backend", ["python", "native"])
def test_video_frames_reach_ffmpeg(fake_ffmpeg, native_dir, backend):
    """tests/test_video.py:33: probe -> spawn -> raw RGBA frames down the
    pipe -> finish, for either backend."""
    rec = Recorder(backend=backend)
    assert rec.backend == backend
    assert rec.ffmpeg_installed
    rec.start(ImageDimensions.new(32, 16))
    assert rec.is_recording
    frames = [np.full((16, 32, 4), i * 10, np.uint8) for i in range(3)]
    for f in frames:
        rec.record(f)
    rec.close()
    raws = [f for f in os.listdir("recordings") if f.endswith(".raw")]
    assert raws, f"no raw capture in {os.listdir('recordings')}"
    with open(os.path.join("recordings", raws[0]), "rb") as f:
        data = f.read()
    assert data == b"".join(f.tobytes() for f in frames)


def test_resize_mid_recording_finishes_video(fake_ffmpeg):
    """lib.rs:109-113: a resize stops an active recording."""
    from vokselis_torch.engine.context import Context
    from vokselis_torch.engine.loop import run
    from vokselis_torch.models.trig import TrigDemo

    events = [
        {"type": "key", "key": "f12", "pressed": True},
        None,
        {"type": "resize", "width": 48, "height": 32},
        None,
    ]
    run(TrigDemo, width=32, height=16, frames=3, events=iter(events), quiet=True,
        context=Context(32, 16, backbuffer_resolution=(32, 16), device="cpu"))
    time.sleep(0.3)
    raws = [f for f in os.listdir("recordings") if f.endswith(".raw")]
    assert raws  # the recording was started and finished (by the resize)
