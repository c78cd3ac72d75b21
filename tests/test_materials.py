"""Full PBR material set: texture atlases, normal mapping via
derivative-reconstructed tangent frames, metallic-roughness + emissive maps
(reference bakes all four per material, zenith-asset/src/render.rs:135-176;
round-2 rendered only base color — VERDICT r2 missing #4)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from zenith.rhi.atlas import build_atlas
from zenith.rhi.formats import Format
from zenith.rhi.resource import Texture


def _solid(name, color, size=8, fmt=Format.RGBA32F):
    px = np.broadcast_to(
        np.asarray(color, np.float32), (size, size, 4)
    ).copy()
    return Texture.from_numpy(name, px, fmt)


class TestAtlas:
    def test_pack_and_transform_roundtrip(self):
        """Sampling each input's center through its transform returns that
        input's color."""
        from zenith.ops.sampling import sample_texture
        from zenith.rhi.sampler import SamplerConfig

        colors = [(1, 0, 0, 1), (0, 1, 0, 1), (0, 0, 1, 1)]
        atlas = build_atlas(
            "t", [_solid(f"c{i}", c) for i, c in enumerate(colors)]
        )
        assert atlas.transforms.shape == (3, 4)
        for i, c in enumerate(colors):
            su, sv, ou, ov = atlas.transforms[i]
            uv = jnp.asarray([[[ou + 0.5 * su, ov + 0.5 * sv]]])
            out = sample_texture(
                tuple(atlas.texture.mips) if atlas.texture.mips
                else atlas.texture.array,
                uv, SamplerConfig.linear(),
            )
            np.testing.assert_allclose(
                np.asarray(out)[0, 0, :3], c[:3], atol=1e-5
            )

    def test_none_slot_gets_fallback(self):
        atlas = build_atlas(
            "t", [_solid("a", (1, 0, 0, 1)), None],
            fallback=(0.25, 0.5, 0.75, 1.0),
        )
        su, sv, ou, ov = atlas.transforms[1]
        lvl0 = np.asarray(atlas.texture.array)
        h, w = lvl0.shape[:2]
        x = int(ou * w)
        y = int(ov * h)
        np.testing.assert_allclose(lvl0[y, x, :3], [0.25, 0.5, 0.75])

    def test_mixed_sizes_edge_replicated(self):
        a = _solid("a", (1, 1, 0, 1), size=4)
        b = _solid("b", (0, 1, 1, 1), size=16)
        atlas = build_atlas("t", [a, b])
        # cell = 16x16; a's cell is fully its edge-replicated color
        lvl0 = np.asarray(atlas.texture.array)
        np.testing.assert_allclose(lvl0[10, 10, :3], [1, 1, 0])

    def test_no_cross_cell_bleed_at_level0(self):
        a = _solid("a", (1, 0, 0, 1), size=8)
        b = _solid("b", (0, 0, 1, 1), size=8)
        from zenith.ops.sampling import sample_2d
        from zenith.rhi.sampler import SamplerConfig

        atlas = build_atlas("t", [a, b])
        su, sv, ou, ov = atlas.transforms[0]
        # The extreme edges of input space map to texel centers (the
        # half-texel inset) — bilinear never reaches the neighbor cell.
        for u, v in [(0, 0), (1, 0), (0, 1), (1, 1)]:
            uv = jnp.asarray([[[ou + u * su, ov + v * sv]]])
            out = sample_2d(
                atlas.texture.array, uv, SamplerConfig.linear()
            )
            np.testing.assert_allclose(
                np.asarray(out)[0, 0, :3], [1, 0, 0], atol=1e-5
            )

    def test_gutter_protects_deep_mips(self):
        """Inputs smaller than their pow2 cell get a gutter ring out of the
        cell's slack: bilinear taps at coarse mips stay inside the input's
        replicated content instead of bleeding into the neighbor cell."""
        from zenith.ops.sampling import pack_mips, sample_2d_lod
        from zenith.rhi.sampler import SamplerConfig

        # 24x24 inputs -> 32x32 cells, slack 8 -> 4-texel gutter each side:
        # protected while (4 + 0.5) / 2^k >= 0.5, i.e. through level 3.
        a = _solid("a", (1, 0, 0, 1), size=24)
        b = _solid("b", (0, 0, 1, 1), size=24)
        atlas = build_atlas("t", [a, b])
        packed = pack_mips(list(atlas.texture.mips))
        cfg = SamplerConfig.linear()
        for i, color in [(0, [1, 0, 0]), (1, [0, 0, 1])]:
            su, sv, ou, ov = atlas.transforms[i]
            for lod in (2.0, 3.0):
                for u, v in [(0, 0), (1, 0), (0, 1), (1, 1)]:
                    uv = jnp.asarray([[[ou + u * su, ov + v * sv]]])
                    out = sample_2d_lod(
                        packed, uv, jnp.float32(lod), cfg
                    )
                    np.testing.assert_allclose(
                        np.asarray(out)[0, 0, :3], color, atol=1e-5,
                        err_msg=f"input {i} bled at lod {lod} uv=({u},{v})",
                    )

    def test_explicit_gutter_grows_cells_for_guaranteed_ring(self):
        """gutter=G on pow2 inputs (no natural slack) grows the cell and
        keeps deep-mip taps pure."""
        from zenith.ops.sampling import pack_mips, sample_2d_lod
        from zenith.rhi.sampler import SamplerConfig

        a = _solid("a", (1, 0, 0, 1), size=16)
        b = _solid("b", (0, 0, 1, 1), size=16)
        # Zero-arg default on exactly-pow2 inputs: no slack, gutter 0 — the
        # level-0 half-texel contract (tested above) is all you get.
        tight = build_atlas("t0", [a, b])
        assert tight.texture.desc.width == 32  # 2 cols x 16

        atlas = build_atlas("t", [a, b], gutter=8)
        # 16 + 2*8 = 32-texel cells, 2 cols.
        assert atlas.texture.desc.width == 64
        packed = pack_mips(list(atlas.texture.mips))
        cfg = SamplerConfig.linear()
        su, sv, ou, ov = atlas.transforms[0]
        for lod in (2.0, 4.0):
            uv = jnp.asarray([[[ou + 1.0 * su, ov + 0.5 * sv]]])
            out = sample_2d_lod(packed, uv, jnp.float32(lod), cfg)
            np.testing.assert_allclose(
                np.asarray(out)[0, 0, :3], [1, 0, 0], atol=1e-5,
                err_msg=f"explicit gutter bled at lod {lod}",
            )


class TestPerturbNormal:
    def _planes(self, h=16, w=16):
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        world = np.stack([xs / 4.0, ys / 4.0, np.zeros_like(xs)], -1)
        uv = np.stack([xs / w, ys / h], -1)
        n = np.broadcast_to(np.asarray([0.0, 0.0, 1.0], np.float32), (h, w, 3))
        return jnp.asarray(n), jnp.asarray(world), jnp.asarray(uv)

    def test_flat_map_preserves_normal(self):
        from zenith.ops.shade import perturb_normal

        n, world, uv = self._planes()
        flat = jnp.broadcast_to(jnp.asarray([0.5, 0.5, 1.0]), n.shape)
        out = np.asarray(perturb_normal(n, world, uv, flat))
        np.testing.assert_allclose(out, np.asarray(n), atol=1e-5)

    def test_tilted_map_tilts_along_tangent(self):
        from zenith.ops.shade import perturb_normal

        n, world, uv = self._planes()
        # Tangent-space +x tilt: world tangent follows d(world)/d(u) = +x.
        tilt = jnp.broadcast_to(
            jnp.asarray([0.5 + 0.35, 0.5, 0.85]), n.shape
        )
        out = np.asarray(perturb_normal(n, world, uv, tilt))
        center = out[8, 8]
        assert center[0] > 0.2  # tilted toward +x
        assert center[2] > 0.5  # still mostly +z
        np.testing.assert_allclose(np.linalg.norm(center), 1.0, atol=1e-5)

    def test_degenerate_uv_falls_back_to_geometric(self):
        from zenith.ops.shade import perturb_normal

        n, world, uv = self._planes()
        const_uv = jnp.zeros_like(uv)  # zero uv derivatives everywhere
        bump = jnp.broadcast_to(jnp.asarray([0.9, 0.1, 0.5]), n.shape)
        out = np.asarray(perturb_normal(n, world, const_uv, bump))
        np.testing.assert_allclose(out, np.asarray(n), atol=1e-5)


class TestGBufferMaterialSet:
    """Unit-level: run the G-buffer fragment stage with atlased maps."""

    def _run_fs(self, objs_textures, res_extra=None, h=8, w=8):
        from zenith.renderer.deferred import _UVX_NAME, _make_gbuffer_fs
        from zenith.rhi.shader import FragmentBuiltins

        fs = _make_gbuffer_fs(
            True,
            use_normal="NormalAtlas" in objs_textures,
            use_mra="MraAtlas" in objs_textures,
            use_emissive="EmissiveAtlas" in objs_textures,
        )
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        varyings = {
            "normal": jnp.broadcast_to(
                jnp.asarray([0.0, 0.0, 1.0]), (h, w, 3)
            ),
            "world_pos": jnp.asarray(
                np.stack([xs, ys, np.zeros_like(xs)], -1)
            ),
            "uv": jnp.asarray(np.stack([xs / w, ys / h], -1)),
        }
        res = {
            "BaseColor": jnp.asarray([1.0, 1.0, 1.0, 1.0]),
            "MatParams": jnp.asarray([1.0, 1.0, 1.0, 0.0]),
        }
        for name, atlas in objs_textures.items():
            res[name] = (
                tuple(atlas.texture.mips) if atlas.texture.mips
                else atlas.texture.array
            )
            res[_UVX_NAME[name]] = jnp.asarray(atlas.transforms[0])
        if res_extra:
            res.update(res_extra)
        builtins = FragmentBuiltins(
            frag_coord=jnp.zeros((h, w, 2)),
            depth=jnp.ones((h, w)),
            front_facing=jnp.ones((h, w), bool),
            resolution=(w, h),
        )
        return fs(varyings, res, builtins)

    def test_mra_modulates_metallic_roughness(self):
        mra = build_atlas(
            "m", [_solid("m0", (1.0, 0.25, 0.75, 1.0))]
        )  # G=rough 0.25, B=metal 0.75
        base = build_atlas("b", [None])
        out = self._run_fs({"BaseAtlas": base, "MraAtlas": mra})
        assert np.asarray(out["0_albedo"])[4, 4, 3] == pytest.approx(0.75, abs=1e-3)
        assert np.asarray(out["1_normal"])[4, 4, 3] == pytest.approx(0.25, abs=1e-3)

    def test_emissive_map_luma(self):
        em = build_atlas("e", [_solid("e0", (0.0, 1.0, 0.0, 1.0))])
        base = build_atlas("b", [None])
        out = self._run_fs({"BaseAtlas": base, "EmissiveAtlas": em})
        assert np.asarray(out["2_pos"])[4, 4, 3] == pytest.approx(
            0.7152, abs=1e-3
        )

    def test_normal_map_bends_gbuffer_normal(self):
        tilt = _solid("n0", (0.85, 0.5, 0.65, 1.0))  # +x tilt
        nrm = build_atlas("n", [tilt], mip_levels=1)
        base = build_atlas("b", [None])
        out = self._run_fs({"BaseAtlas": base, "NormalAtlas": nrm})
        n_out = np.asarray(out["1_normal"])[4, 4, :3]
        # Map vector (0.7, 0, 0.3) normalizes to ≈ (0.92, 0, 0.39).
        assert n_out[0] > 0.8 and 0.2 < n_out[2] < 0.6
        np.testing.assert_allclose(np.linalg.norm(n_out), 1.0, atol=1e-4)


class TestEndToEndMaterials:
    def test_textured_scene_with_normal_map_changes_shading(self):
        """Full deferred pipeline: same quad scene with and without a bump
        normal map — the lit result must differ inside the surface (visible
        normal-map response, VERDICT r2 'done' criterion)."""
        from zenith.core.camera import Camera
        from zenith.core.mathtypes import Degree, Radians
        from zenith.renderer import DeferredRenderer
        from zenith.renderer.scene import DirectionalLight, Scene, SceneObject
        from zenith.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith.rhi import PipelineCache, RhiCore, TextureDesc
        from zenith.sandbox.scene import bump_normal_texture, checker_texture

        core = RhiCore()
        device = core.create_render_device()
        w, h = 128, 64

        def render(with_bumps: bool):
            ground = SceneObject.quad(
                device, "ground", size=60.0, z=0.0,
                base_color=(0.8, 0.8, 0.8, 1.0), roughness=0.4,
                base_color_texture=checker_texture(size=64, cells=4),
                normal_texture=(
                    bump_normal_texture(size=64, bumps=4) if with_bumps
                    else None
                ),
            )
            scene = Scene(
                objects=[ground],
                sun=DirectionalLight(
                    direction=(0.5, -0.3, 0.6), cast_shadows=False
                ),
            )
            renderer = DeferredRenderer(scene)
            camera = Camera(fov_y=Degree(45.0), aspect_ratio=w / h)
            camera.set_position(np.array([0.0, -40.0, 25.0], np.float32))
            camera.set_yaw_pitch(Radians(0.0), Radians(-0.55))
            builder = RenderGraphBuilder()
            out = builder.create(TextureDesc.color("out", w, h))
            builder.export(out)
            renderer.render_to(builder, out, camera, w, h)
            compiled = builder.build().compile(
                device, PipelineCache(), CompileOptions(tile_h=8, tile_w=128)
            )
            compiled.execute(device)
            return np.asarray(compiled.value(out))

        flat = render(False)
        bumpy = render(True)
        assert flat.shape == bumpy.shape
        diff = np.abs(flat[..., :3] - bumpy[..., :3])
        covered = diff.max(axis=-1) > 1e-3
        # The bump response must be visible over a meaningful area.
        assert covered.mean() > 0.05, f"normal map changed only {covered.mean():.1%} of pixels"
        # And the un-normal-mapped image is smooth where bumps add variance.
        region = slice(40, 56), slice(32, 96)
        assert bumpy[region].std() > flat[region].std()
