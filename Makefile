# Test tiers (CPU; the Pallas kernels run in the interpreter):
#   make gate   — every subsystem's core correctness (ops/raster
#                 fixed-function + parts, rendergraph, rhi, core, asset,
#                 engine, viewer, one golden smoke). Run between edits and
#                 before any commit touching the render path.
#   make check  — exhaustive: the full suite + graft entry.
#   make quick  — core sanity while iterating.
# On a machine with an NVIDIA GPU:
#   make chip   — chip_smoke.py (kernels compiled on the card, the scene).
#   make bench  — one JSON line: the scene's frame rate on the card.
.PHONY: check test gate quick bench chip entry

check: test entry
	@echo "check: suite green + graft entry compiles"

test:
	python -m pytest tests/ -q

# Broad-but-fast tier: every subsystem represented, heavyweight scene
# e2e / SPMD bit-equality / golden-corpus files stay in `make check`.
GATE_FILES = tests/test_math.py tests/test_camera.py tests/test_input.py \
  tests/test_native.py tests/test_dds.py tests/test_asset.py \
  tests/test_rhi.py tests/test_vertex_inputs.py tests/test_texture_types.py \
  tests/test_raster.py tests/test_fixedfunc.py tests/test_lines_points.py \
  tests/test_stencil.py tests/test_raster_parts.py \
  tests/test_rendergraph.py tests/test_subresource.py tests/test_blend_e2e.py \
  tests/test_engine.py tests/test_viewer.py tests/test_golden.py

gate:
	python -m pytest $(GATE_FILES) -q

# The fast correctness core (~2 min): run between edits.
quick:
	python -m pytest tests/test_raster.py tests/test_fixedfunc.py \
	  tests/test_rendergraph.py tests/test_input.py tests/test_camera.py \
	  tests/test_viewer.py -q

# Driver-facing surfaces must at least import + trace.
entry:
	python -c "import __graft_entry__ as g; fn, args = g.entry(); print('entry ok')"

bench:
	python bench.py

chip:
	python chip_smoke.py
