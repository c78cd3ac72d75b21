"""Kernel routing, references and helpers, on the CPU.

The raster and lights kernels run in the Pallas interpreter here and are
checked against their plain-XLA twins (the same references chip_smoke.py
compares the compiled kernels with on the GPU); plus the platform → route
choice, the float32 precision scope, the compile-cache helper and the
device-derived draw caps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zenith.ops import TileGrid, bin_segmented, setup_with_attrs
from zenith.ops import runtime
from zenith.ops.raster import (
    raster_segmented,
    raster_segmented_blend,
    raster_segmented_xla,
)
from zenith.rhi.state import CompareOp, CullMode, StencilOp, StencilOpState

W, H = 70, 30  # not tile multiples: exercises padding and cropping


def _bins(rng, grid, n_tris=40, n_vary=4):
    nv = 3 * n_tris
    pos = rng.uniform(-1.1, 1.1, (nv, 2))
    z = rng.uniform(0.05, 0.95, (nv, 1))
    w = rng.uniform(0.7, 2.5, (nv, 1))
    clip = np.concatenate([pos * w, z * w, w], 1).astype(np.float32)
    idx = np.arange(nv, dtype=np.int32).reshape(-1, 3)
    vary = rng.uniform(0, 1, (nv, n_vary)).astype(np.float32)
    rec, corner = setup_with_attrs(jnp.asarray(clip), jnp.asarray(idx),
                                   jnp.asarray(vary), W, H,
                                   cull_mode=CullMode.NONE)
    return bin_segmented(rec, corner, grid)


def _blend(planes, passed, x, y, zpx, c):
    iw = jnp.maximum(planes[-1], 1e-20)
    out = [jnp.where(passed, 0.3 * planes[i] / iw + 0.7 * c[i], c[i])
           for i in range(3)]
    return tuple(out) + (jnp.where(passed, 0.3 + 0.7 * c[3], c[3]),)


FRONT = StencilOpState(pass_op=StencilOp.INCREMENT_AND_WRAP,
                       depth_fail_op=StencilOp.INVERT,
                       compare_op=CompareOp.ALWAYS)
BACK = StencilOpState(pass_op=StencilOp.REPLACE, fail_op=StencilOp.ZERO,
                      compare_op=CompareOp.LESS_OR_EQUAL, reference=1)

VARIANTS = {
    "opaque": ({}, False),
    "stencil": (dict(stencil_front=FRONT, stencil_back=BACK), False),
    "peel": (dict(z_bound=jnp.full((H, W), 0.6, jnp.float32)), False),
    "blend": ({}, True),
    "blend_stencil": (dict(stencil_front=FRONT), True),
}


class TestRasterVariantsMatchXla:
    @pytest.mark.parametrize("name", list(VARIANTS))
    @pytest.mark.parametrize("tile", [(16, 16), (8, 32)])
    def test_interpreter_matches_plain_xla(self, rng, name, tile):
        kw, blend = VARIANTS[name]
        grid = TileGrid(width=W, height=H, tile_h=tile[0], tile_w=tile[1])
        bins = _bins(rng, grid)
        z0 = jnp.zeros((H, W), jnp.float32)
        c0 = jnp.full((H, W, 4), 0.25, jnp.float32)
        kw = dict(kw)
        if "stencil_front" in kw:
            kw["init_stencil"] = jnp.asarray(
                rng.integers(0, 4, (H, W)), jnp.int32)
        if blend:
            got = raster_segmented_blend(bins, grid, z0, c0, _blend,
                                         depth_write=True, **kw)
            want = raster_segmented_xla(bins, grid, z0, init_color=c0,
                                        shade_blend=_blend, depth_write=True,
                                        **kw)
        else:
            got = raster_segmented(bins, grid, z0, **kw)
            want = raster_segmented_xla(bins, grid, z0, **kw)
        assert int(bins.overflow) == 0
        assert len(got) == len(want) == (3 if "stencil_front" in kw else 2)
        assert got[0].shape == (H, W)
        assert got[1].shape == ((H, W, 4) if blend else (6, H, W))
        for g, r in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                       atol=1e-6, rtol=1e-5)
        assert (np.asarray(got[0]) > 0).any()


class TestLightsKernelMatchesDense:
    @pytest.mark.parametrize("spots", [False, True])
    def test_interpreter_matches_dense(self, rng, spots):
        from zenith.ops.lighting import (
            accumulate_point_lights,
            accumulate_point_lights_dense,
        )

        n = rng.normal(size=(H, W, 3))
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        am = np.concatenate([rng.uniform(0.1, 1, (H, W, 3)),
                             rng.uniform(0, 1, (H, W, 1))], -1)
        nr = np.concatenate([n, rng.uniform(0.05, 1, (H, W, 1))], -1)
        pe = np.concatenate([rng.uniform(-20, 20, (H, W, 3)),
                             np.zeros((H, W, 1))], -1)
        depth = (rng.uniform(0, 1, (H, W)) > 0.3) * 0.5
        nl = 9
        lp = rng.uniform(-25, 25, (nl, 3))
        lc = rng.uniform(0.5, 8, (nl, 3))
        lr = rng.uniform(3, 15, (nl,))
        args = [jnp.asarray(a, jnp.float32) for a in
                (am, nr, pe, depth, [0.0, -30.0, 10.0], lp, lc, lr)]
        sp = None
        if spots:
            d = rng.normal(size=(nl, 3))
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            d[::2] = 0.0  # every other light stays a point light
            sp = jnp.asarray(np.concatenate(
                [d, np.full((nl, 1), 0.9), np.full((nl, 1), 0.7)], 1),
                jnp.float32)
        got = np.asarray(accumulate_point_lights(*args, spot_params=sp))
        want = np.asarray(accumulate_point_lights_dense(*args, spot_params=sp))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        assert got.max() > 0.01


class TestRoute:
    @pytest.mark.parametrize("platform,interpret",
                             [("cpu", True), ("gpu", False)])
    def test_known_platforms(self, platform, interpret):
        assert runtime.pallas_interpret(platform) is interpret

    @pytest.mark.parametrize("platform", ["opencl", "rocm", "METAL"])
    def test_unknown_platform_raises(self, platform):
        with pytest.raises(RuntimeError, match="no Pallas route"):
            runtime.pallas_interpret(platform)

    def test_default_device_routes_the_tests_to_the_interpreter(self):
        assert runtime.default_platform() == "cpu"
        assert runtime.pallas_interpret() is True

    def test_kernels_name_the_triton_route(self):
        """Every pallas_call names backend="triton": lowered for CUDA (on
        this CPU host) the kernel becomes a Triton custom call."""
        grid = TileGrid(width=W, height=H)
        bins = _bins(np.random.default_rng(0), grid, n_tris=4)
        z0 = jnp.zeros((H, W), jnp.float32)
        text = jax.jit(
            lambda b: raster_segmented(b, grid, z0, interpret=False)
        ).trace(bins).lower(lowering_platforms=("cuda",)).as_text()
        assert "xla.gpu.triton" in text
        assert "stablehlo.while" not in text


class TestPrecision:
    def test_highest_precision_scope(self):
        seen = []

        def fn(a):
            seen.append(jax.config.jax_default_matmul_precision)
            return a @ a

        out = runtime.highest_precision(fn)(jnp.eye(2))
        np.testing.assert_array_equal(np.asarray(out), np.eye(2))
        assert seen == ["highest"]
        assert jax.config.jax_default_matmul_precision != "highest"

    def test_transform_vertices_asks_for_float32(self):
        from zenith.ops.geometry import transform_vertices

        jaxpr = jax.make_jaxpr(transform_vertices)(
            jnp.zeros((5, 3)), jnp.eye(4))
        dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
        assert dots and all(
            "HIGHEST" in str(e.params["precision"]) for e in dots)

    def test_frame_program_traces_under_highest(self, monkeypatch):
        """The render graph wraps the frame function it jits."""
        import zenith.rendergraph.graph as G

        wrapped = []
        orig = G.highest_precision

        def spy(fn):
            wrapped.append(fn)
            return orig(fn)

        monkeypatch.setattr(G, "highest_precision", spy)
        from zenith.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith.rhi import RhiCore, TextureDesc, PipelineCache

        device = RhiCore().create_render_device()
        b = RenderGraphBuilder()
        t = b.create(TextureDesc.color("t", 8, 8))
        b.export(t)
        node = b.add_lambda_node("fill")
        out = node.write(t)
        node.execute(lambda ctx: ctx.set(out, jnp.ones((8, 8, 4))))
        G._FRAME_PROGRAM_CACHE.clear()
        b.build().compile(device, PipelineCache(), CompileOptions())
        assert len(wrapped) == 1


class TestCompileCacheHelper:
    def _fresh(self, monkeypatch):
        import zenith.engine as E

        calls = {}
        monkeypatch.setattr(E, "_compile_cache_ready", False)
        monkeypatch.setattr(jax.config, "update",
                            lambda k, v: calls.__setitem__(k, v))
        return E, calls

    def test_env_var_set_means_no_dir_in_code(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        E, calls = self._fresh(monkeypatch)
        E.ensure_persistent_compile_cache()
        assert "jax_compilation_cache_dir" not in calls

    def test_default_is_the_checkout_cache(self, monkeypatch, tmp_path):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.chdir(tmp_path)  # independent of the working directory
        E, calls = self._fresh(monkeypatch)
        E.ensure_persistent_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(E.__file__)))
        assert calls["jax_compilation_cache_dir"] == os.path.join(
            root, ".jax_cache")


class TestDrawCaps:
    def test_no_limit_no_cap(self, monkeypatch):
        import zenith.ops.draw as D

        monkeypatch.setattr(D, "MAX_RECORDS_PER_RASTER", None)
        monkeypatch.setattr(D, "MAX_PRIMS_PER_PART", None)
        assert D._draw_caps(46) == (None, None)  # the CPU reports no limit

    def test_caps_follow_the_device_memory(self, monkeypatch):
        import zenith.ops.draw as D

        class Dev:
            platform = "gpu"

            @staticmethod
            def memory_stats():
                return {"bytes_limit": 60 * 2**30}

        monkeypatch.setattr(D, "MAX_RECORDS_PER_RASTER", None)
        monkeypatch.setattr(D, "MAX_PRIMS_PER_PART", None)
        monkeypatch.setattr(runtime, "default_device", lambda: Dev)
        rec, prim = D._draw_caps(46)
        assert rec == 60 * 2**30 // (D._PART_MEMORY_SHARE * D._record_bytes(46))
        assert prim == rec // 3
        wide, _ = D._draw_caps(100)
        assert wide < rec  # wider rows, fewer records per part

    def test_overrides_win(self, monkeypatch):
        import zenith.ops.draw as D

        monkeypatch.setattr(D, "MAX_RECORDS_PER_RASTER", 64)
        monkeypatch.setattr(D, "MAX_PRIMS_PER_PART", 16)
        assert D._draw_caps(46) == (64, 16)


def test_default_entry_budget_covers_full_screen_records():
    from zenith.ops.binning import default_entry_budget

    assert default_entry_budget(10, 100) == 8192 + 200
    assert default_entry_budget(10_000, 8160) == 40_000 + 2 * 8160
