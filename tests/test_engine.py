"""Engine-loop e2e: the retained path (update_dynamics) must produce the
same frames as the reference-parity rebuild-every-frame path."""

import numpy as np

from zenith.app import RenderableApp, RenderContext
from zenith.launch import launch
from zenith.window import Window

W, H = 128, 32


class _TriApp(RenderableApp):
    """Animated triangle keyed by FRAME INDEX (deterministic across runs);
    retained subclass overrides update_dynamics."""

    retained = False

    def __init__(self, args):
        super().__init__(args)
        self.frame = 0
        self.renderer = None

    def prepare(self, render_device, window):
        from zenith.renderer import TriangleRenderer

        self.renderer = TriangleRenderer(render_device)

    def tick(self, dt):
        self.frame += 1

    def _time(self):
        return np.float32(self.frame * 0.25)

    def update_dynamics(self):
        if not self.retained:
            return None
        return self.renderer.frame_dynamics(self._time())

    def render(self, context: RenderContext):
        builder = context.builder()
        out = builder.import_resource(context.swapchain_texture())
        w, h = context.extent
        self.renderer.render_to(builder, out, w, h, time_s=self._time())


class _TriAppRetained(_TriApp):
    retained = True


def _run(app_class):
    from zenith.rendergraph.graph import clear_frame_program_cache

    clear_frame_program_cache()
    window = Window(width=W, height=H, title="t")
    loop = launch(app_class, argv=[], window=window, max_frames=5)
    assert loop.frames_rendered == 5
    assert window.last_frame is not None
    return np.asarray(window.last_frame)


class TestRetainedEngineLoop:
    def test_retained_frames_match_rebuild_frames(self):
        rebuild = _run(_TriApp)
        retained = _run(_TriAppRetained)
        assert rebuild.shape == retained.shape == (H, W, 4)
        np.testing.assert_array_equal(retained, rebuild)
        # The animation actually moved off the clear color somewhere.
        assert rebuild[..., :3].std() > 1.0


class TestRetainedInvalidation:
    def test_invalidate_retained_forces_rebuild(self):
        """After invalidate_retained() (hot-reload path), the next frame
        goes through app.render again instead of the retained program."""
        from zenith.engine import Engine

        calls = []

        class App(_TriAppRetained):
            def render(self, context):
                calls.append(self.frame)
                super().render(context)

        from zenith.core.cli import EngineArgs

        window = Window(width=W, height=H, title="t")
        engine = Engine(window)
        app = App(EngineArgs.parse_args([]))
        app.prepare(engine.render_device, window)
        engine.render(app)  # frame 0: rebuild (populates retained)
        app.tick(0.016)
        engine.render(app)  # frame 1: retained — no render() call
        assert calls == [0]
        engine.invalidate_retained()
        app.tick(0.016)
        engine.render(app)  # frame 2: rebuild again
        assert calls == [0, 2]
        engine.shutdown()


class TestPresentFrom:
    def test_present_from_encoded_node(self):
        """An app using PresentEncode + context.present_from presents the
        pre-encoded uint8 frame (swapchain skips its own encode), and the
        delivered frame matches encoding the linear output."""
        from zenith.renderer import PresentEncode
        from zenith.rhi import Format, TextureDesc
        from zenith.rhi.formats import encode_present

        class App(_TriApp):
            def render(self, context):
                builder = context.builder()
                out = builder.import_resource(context.swapchain_texture())
                w, h = context.extent
                enc = builder.create(
                    TextureDesc.color("enc", w, h, Format.BGRA8_SRGB)
                )
                builder.export(enc)
                self.renderer.render_to(builder, out, w, h, time_s=self._time())
                PresentEncode(Format.BGRA8_SRGB).render_to(builder, out, enc)
                context.present_from(enc)
                self._linear_handle = out

        from zenith.rendergraph.graph import clear_frame_program_cache

        clear_frame_program_cache()
        window = Window(width=W, height=H, title="t")
        loop = launch(App, argv=[], window=window, max_frames=3)
        assert loop.frames_rendered == 3
        frame = np.asarray(window.last_frame)
        assert frame.dtype == np.uint8 and frame.shape == (H, W, 4)
        # Encoded output actually carries the triangle (non-constant image).
        assert frame[..., :3].std() > 1.0


class TestResize:
    def test_engine_resize_mid_run(self):
        """Resize between frames: the swapchain rebuilds, the retained
        program drops, and the next frames render at the new extent."""
        from zenith.core.cli import EngineArgs
        from zenith.core.events import WindowEvent
        from zenith.engine import Engine
        from zenith.window import Window

        window = Window(width=96, height=32, title="t")
        app = _TriAppRetained(EngineArgs())
        engine = Engine(window)
        app.prepare(engine.render_device, window)
        for _ in range(2):
            app.tick(0.016)
            engine.render(app)
        engine.resize(128, 64)
        app.resize(128, 64)
        assert engine._retained is None  # structure changed → rebuild
        for _ in range(2):
            app.tick(0.016)
            engine.render(app)
        engine.shutdown()
        frame = np.asarray(window.last_frame)
        assert frame.shape == (64, 128, 4)

    def test_sceneapp_resize_updates_jitter_extent_and_resets_taa(self):
        """SceneApp.resize must follow the window (stale extents mis-scale
        the TAA jitter) and drop the TAA history (shape change)."""
        from zenith.core.cli import EngineArgs
        from zenith.renderer import TemporalAA
        from zenith.sandbox.scene import SceneApp

        app = SceneApp(EngineArgs(app_args=["--taa"]))
        app.taa = TemporalAA()
        app._extent = (100, 50)
        app.taa._history = object()  # stand-in: anything non-None
        app.taa._hw = (50, 100)
        app.resize(200, 100)
        assert app._extent == (200, 100)
        assert app.taa._history is None  # history dropped


class TestAutoRetained:
    """Auto-retained execution: apps that provide update_dynamics get the
    retained path BY DEFAULT — app.render runs once, every later frame is
    one pack + one dispatch of the cached program."""

    def test_triangle_app_auto_retains(self):
        from zenith.sandbox.triangle import TriangleApp

        calls = []

        class App(TriangleApp):
            def render(self, context):
                calls.append(1)
                super().render(context)

        from zenith.rendergraph.graph import clear_frame_program_cache

        clear_frame_program_cache()
        window = Window(width=W, height=H, title="t")
        loop = launch(App, argv=[], window=window, max_frames=5)
        assert loop.frames_rendered == 5
        assert len(calls) == 1  # frames 2-5 re-executed the cached program
        frame = np.asarray(window.last_frame)
        assert frame[..., :3].std() > 1.0

    def test_scene_app_auto_retains_and_structure_fallback(self):
        """SceneApp defaults to auto-retained; mark_structure_dirty routes
        ONE frame through the rebuild path (the structure-change fallback),
        then retained execution resumes."""
        from zenith.core.cli import EngineArgs
        from zenith.engine import Engine
        from zenith.sandbox.scene import SceneApp

        calls = []

        class App(SceneApp):
            def render(self, context):
                calls.append(1)
                super().render(context)

        window = Window(width=128, height=64, title="t")
        engine = Engine(window)
        app = App(EngineArgs(app_args=[
            "--mode", "deferred", "--lights", "2",
        ]))
        app.prepare(engine.render_device, window)
        for _ in range(3):
            app.tick(0.016)
            engine.render(app)
        assert len(calls) == 1  # frames 2-3 retained
        app.mark_structure_dirty()
        app.tick(0.016)
        engine.render(app)
        assert len(calls) == 2  # fallback: rebuild path ran once
        app.tick(0.016)
        engine.render(app)
        assert len(calls) == 2  # retained again
        engine.shutdown()
        frame = np.asarray(window.last_frame)
        assert frame[..., :3].std() > 1.0

    def test_no_retained_flag_rebuilds_every_frame(self):
        from zenith.core.cli import EngineArgs
        from zenith.engine import Engine
        from zenith.sandbox.scene import SceneApp

        calls = []

        class App(SceneApp):
            def render(self, context):
                calls.append(1)
                super().render(context)

        window = Window(width=128, height=64, title="t")
        engine = Engine(window)
        app = App(EngineArgs(app_args=[
            "--mode", "deferred", "--lights", "2", "--no-retained",
        ]))
        app.prepare(engine.render_device, window)
        for _ in range(3):
            app.tick(0.016)
            engine.render(app)
        assert len(calls) == 3
        engine.shutdown()


class TestEntryBudgetGrowth:
    def test_growth_doubles_then_stops_at_the_cap(self):
        """Overflow doubles every draw's entry budget, up to the cap; a
        scene whose overflow doubling cannot absorb stops recompiling."""
        from zenith.engine import Engine

        engine = Engine(Window(width=32, height=16, title="t"))
        scales = [engine.grow_entry_budget() for _ in range(6)]
        assert scales == [2, 4, 8, 16, 16, 16]
        assert engine.compile_options.budget_scale == Engine.MAX_BUDGET_SCALE
        engine.shutdown()
