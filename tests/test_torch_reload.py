"""Hot reload in the port: the kernel compiler (vokselis_torch.engine.
compiler), the source watcher (engine.reload), the context's watch mode and
the xor demo's reloadable field pipeline.

Mirrors tests/test_engine.py:95-118 (the compiler's success,
failure-with-diagnostics and cache cases), :156 (the watcher swaps a
pipeline and survives a failed edit) and tests/test_reload.py:17 (the xor
field's edit -> live-swap loop end to end, here on the plain version's path
with a torch field module in ``tmp_path``). The CUDA source rebuild (nvcc,
a new library per good edit, the last good one kept on a failed edit) is
the ``gpu`` test at the end; on the CPU the same watcher drives a failed
header edit through the compiler, which reports the build's diagnostics.
"""

import importlib.util
import os
import shutil
import sys
import time

import pytest
import torch

from vokselis_torch.core.camera import Camera
from vokselis_torch.engine.compiler import CompileResult, KernelCompiler
from vokselis_torch.engine.context import Context
from vokselis_torch.engine.loop import run
from vokselis_torch.engine.reload import FnPipeline, ReloadablePipeline, Watcher
from vokselis_torch.models.trig import TrigDemo
from vokselis_torch.models.xor import FieldPipeline, XorDemo
from vokselis_torch.ops.cuda import march_field
from vokselis_torch.volume import fields_soa

FIELD_V1 = """
import torch

def _field(x, y, z, t, val):
    r = torch.sqrt(x * x + y * y + z * z)
    alpha = torch.where(r < 0.4, 0.6, 0.0)
    zero = torch.zeros_like(x)
    return torch.full_like(x, val), alpha, zero, zero - 1.0, zero

def noise_volume_grad_analytic(x, y, z, t):
    return _field(x, y, z, t, 0.5)

noise_volume_grad = noise_volume_grad_analytic
"""

FIELD_V2 = FIELD_V1.replace("0.5)", "0.9)").replace("0.6,", "0.9,")


def _touch(path, text):
    """Rewrite ``path`` and move its mtime on, even on coarse clocks."""
    path.write_text(text)
    st = path.stat()
    os.utime(path, (st.st_atime, st.st_mtime + 2))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


class TestCompiler:
    def test_success(self):
        res = KernelCompiler().create_kernel(lambda x: x * 2, (torch.ones(4),))
        assert res.ok and bool(res) and res.error == "" and res.seconds >= 0.0
        assert res.compiled(torch.arange(4.0)).tolist() == [0, 2, 4, 6]

    def test_failure_returns_diagnostics(self):
        def bad(x):
            return x @ torch.ones((5, 5))  # shape mismatch

        res = KernelCompiler().create_kernel(bad, (torch.ones((3, 4)),))
        assert not res.ok and not bool(res) and res.compiled is None
        assert "Error" in res.error and "bad" in res.error  # the traceback

    def test_cache(self):
        c = KernelCompiler()
        r1 = c.create_kernel_cached("k", lambda x: x + 1, (torch.ones(2),))
        r2 = c.create_kernel_cached("k", lambda x: x + 1, (torch.ones(2),))
        assert r1 is r2
        bad = c.create_kernel_cached("b", lambda x: x @ x, (torch.ones(3, 2),))
        assert not bad.ok
        assert c.create_kernel_cached("b", lambda x: x, (torch.ones(3, 2),)).ok  # retried

    def test_cuda_source_failure_returns_diagnostics(self, tmp_path):
        """A .cu source that cannot build: ``error`` holds the build's
        output (nvcc's diagnostics on a card's machine; here, with no nvcc,
        the missing compiler) and nothing is loaded."""
        src = tmp_path / "broken.cu"
        src.write_text('extern "C" int vk_f( { return 0; }\n')
        res = KernelCompiler().create_kernel(src)
        assert not res.ok and res.compiled is None
        assert ("nvcc not found" in res.error) or ("error" in res.error)


class TestWatcher:
    def test_reload_swaps_and_survives_failure(self, tmp_path, capsys):
        mod_path = tmp_path / "hotmod_torch.py"
        mod_path.write_text("def kernel():\n    return 1\n")
        module = _load("hotmod_torch", mod_path)
        w = Watcher(autostart=False)
        pipe = w.register(module, FnPipeline(module, "kernel"))
        assert isinstance(pipe, ReloadablePipeline)
        assert pipe() == 1
        assert w.poll_once() == []  # nothing changed

        _touch(mod_path, "def kernel():\n    return 2\n")
        (res,) = w.poll_once()
        assert res.ok and pipe() == 2
        assert "reloaded hotmod_torch.py" in capsys.readouterr().out

        # a broken edit keeps the old kernel (watcher.rs:92-101)
        _touch(mod_path, "def kernel(:\n")
        (res,) = w.poll_once()
        assert not res.ok and "SyntaxError" in res.error
        assert pipe() == 2
        assert "keeping the previous kernel" in capsys.readouterr().err
        del sys.modules["hotmod_torch"]

    def test_thread_polls_and_stops(self, tmp_path):
        mod_path = tmp_path / "hotmod_thread.py"
        mod_path.write_text("VALUE = 1\n")
        module = _load("hotmod_thread", mod_path)
        w = Watcher(poll_interval=0.02)
        pipe = w.register(module, FnPipeline(module, "VALUE"))
        _touch(mod_path, "VALUE = 7\n")
        deadline = time.time() + 10
        while pipe.fn != 7 and time.time() < deadline:
            time.sleep(0.02)
        w.stop()
        assert pipe.fn == 7 and w._thread is None
        del sys.modules["hotmod_thread"]

    def test_kernel_source_and_headers_watched(self, tmp_path, capsys):
        """register_kernel watches a CUDA source and the local headers it
        includes; one header edit rebuilds once through the compiler. A
        broken header cannot build: the result carries the diagnostics and
        the pipeline keeps its library."""
        for name in ("march_field.cu", "fields.cuh"):
            shutil.copy(march_field.CSRC / name, tmp_path / name)

        class Pipe:
            reloads = []

            def reload(self, lib):
                self.reloads.append(lib)

        w = Watcher(autostart=False)
        pipe = w.register_kernel(tmp_path / "march_field.cu", Pipe())
        assert sorted(os.path.basename(p) for p in w.registry) == ["fields.cuh",
                                                                 "march_field.cu"]
        header = tmp_path / "fields.cuh"
        _touch(header, header.read_text() + "\nthis is not C++ ][\n")
        results = w.poll_once()
        assert len(results) == 1 and isinstance(results[0], CompileResult)
        assert not results[0].ok and results[0].error
        assert pipe.reloads == []
        assert "reload of march_field.cu failed" in capsys.readouterr().err


def test_context_watch_and_run(monkeypatch, tmp_path):
    """Context(watch=True) runs the watcher thread; run() stops it when the
    run ends; run(watch=True) starts a given context's watcher."""
    monkeypatch.chdir(tmp_path)
    ctx = Context(8, 8, backbuffer_resolution=(8, 8), watch=True, device="cpu")
    assert isinstance(ctx.shader_compiler, KernelCompiler)
    assert ctx.watcher.compiler is ctx.shader_compiler
    assert ctx.watcher._thread is not None and ctx.watcher._thread.is_alive()
    ctx = run(TrigDemo, frames=1, context=ctx, quiet=True)
    assert ctx.watcher._thread is None
    ctx = Context(8, 8, backbuffer_resolution=(8, 8), device="cpu")
    assert ctx.watcher._thread is None
    ctx = run(TrigDemo, frames=1, context=ctx, quiet=True, watch=True)
    assert ctx.frame == 1 and ctx.watcher._thread is None
    ctx = run(TrigDemo, width=8, height=8, frames=1, quiet=True, watch=True, device="cpu")
    assert ctx.frame == 1


def test_xor_demo_registers_its_field_source():
    """On the CPU the xor pipeline watches the plain version's field module
    (volume/fields_soa.py), as the JAX demo registers fields_soa / fields."""
    ctx = Context(8, 8, backbuffer_resolution=(8, 8), device="cpu")
    demo = XorDemo.init(ctx)
    assert list(ctx.watcher.registry) == [os.path.abspath(fields_soa.__file__)]
    ((kind, name, pipe),) = ctx.watcher.registry[os.path.abspath(fields_soa.__file__)]
    assert (kind, name, pipe) == ("module", fields_soa.__name__, demo.pipeline)
    assert demo.pipeline.fields is fields_soa and demo.pipeline.lib is None


def test_hot_reload_swaps_xor_field_end_to_end(tmp_path):
    """The reference's developer loop (edit shader -> live swap,
    src/watcher.rs:78-90) on the plain path: a field module registered with
    the context watcher is edited on disk; the next poll re-imports it, the
    demo's pipeline rebinds, and the rendered frame changes; a broken edit
    keeps the last good field, bitwise."""
    path = tmp_path / "hotfield_torch.py"
    path.write_text(FIELD_V1)
    mod = _load("hotfield_torch", path)
    ctx = Context(16, 16, backbuffer_resolution=(16, 16), device="cpu")
    demo = XorDemo.init(ctx)
    demo.pipeline.fields = mod
    ctx.watcher.register(mod, demo.pipeline)

    demo.render(ctx)
    img_v1 = ctx.render_backbuffer.texture.clone()
    _touch(path, FIELD_V2)
    assert all(r.ok for r in ctx.watcher.poll_once())
    assert demo.pipeline.fields is sys.modules["hotfield_torch"]
    demo.render(ctx)
    img_v2 = ctx.render_backbuffer.texture.clone()
    assert bool(torch.isfinite(img_v1).all()) and bool(torch.isfinite(img_v2).all())
    assert not torch.allclose(img_v1, img_v2), "reload did not swap the field"

    _touch(path, "this is not python ][")
    assert not any(r.ok for r in ctx.watcher.poll_once())
    demo.render(ctx)
    assert torch.equal(ctx.render_backbuffer.texture, img_v2)
    del sys.modules["hotfield_torch"]


def test_field_module_drives_the_plain_route():
    """render_field takes a field module on the CPU route: fields_soa
    itself gives the default frame bitwise. (On a CUDA uniform it refuses
    one: the kernel's fields are csrc/fields.cuh.)"""
    u = Camera.xor(1.0).uniform("cpu")
    img = march_field.render_field(u, 0.0, 8, 8, fields=fields_soa)
    assert torch.equal(img, march_field.render_field(u, 0.0, 8, 8))
    assert FieldPipeline("cpu").source == march_field.SOURCE


@pytest.mark.gpu
def test_cuda_source_rebuild_on_the_card(tmp_path):
    """XorDemo on a copy of march_field.cu (and its headers): an edit to a
    shading constant rebuilds K7 into a new library and changes the frame;
    a syntax error returns nvcc's diagnostics and the next frame is bitwise
    the last good one; restoring the source gives the unedited frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in ("march_field.cu", "fields.cuh"):
        shutil.copy(march_field.CSRC / name, tmp_path / name)
    src = tmp_path / "march_field.cu"
    original = src.read_text()
    ctx = Context(64, 64, camera=XorDemo.default_camera(1.0), backbuffer_resolution=(64, 64),
                  device="cuda")
    demo = XorDemo.init(ctx, source=src)

    def frame():
        demo.render(ctx)
        torch.cuda.synchronize()
        return ctx.render_backbuffer.texture.clone()

    base, lib0 = frame(), demo.pipeline.lib
    edited = original.replace("const float v = val * 0.5f;", "const float v = val * 0.75f;")
    assert edited != original
    _touch(src, edited)
    (res,) = ctx.watcher.poll_once()
    assert res.ok and demo.pipeline.lib is not lib0
    assert res.compiled._name != lib0._name
    changed = frame()
    assert not torch.equal(changed, base)
    _touch(src, edited + "\nthis is not C++ ][\n")
    (res,) = ctx.watcher.poll_once()
    assert not res.ok and "error" in res.error
    assert torch.equal(frame(), changed)
    _touch(src, original)
    (res,) = ctx.watcher.poll_once()
    assert res.ok and torch.equal(frame(), base)
