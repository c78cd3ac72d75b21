"""Asset manager: content/ sources → cache/ baked, with mtime invalidation
(reference zenith-asset/src/manager.rs).

The reference finds the workspace root by walking up to a [workspace]
Cargo.toml (manager.rs:9-27); here the root is the directory holding a
``content/`` folder, walked up from cwd or given explicitly. ``request_load``
(manager.rs:58-78) bakes when the cache is missing or stale (source mtime
newer, manager.rs:80-115), otherwise deserializes the .mscl manifest and
recursively loads + registers every mesh/material (manager.rs:136-191).
Synchronous/blocking, like the reference.

>>> AssetManager().request_load("mesh/cerberus/scene.gltf")  # doctest: +SKIP
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from zenith.asset import AssetHandle, AssetUrl, registry
from zenith.asset.gltf_loader import GltfLoader, RawGltfProcessor
from zenith.asset.render_types import Material, Mesh, MeshCollection
from zenith.core import log, profile

logger = log.get(__name__)


def find_workspace_root(start: "Optional[Path]" = None) -> Path:
    """Walk up until a directory containing ``content/`` (manager.rs:9-27)."""
    cur = (start or Path.cwd()).resolve()
    for candidate in (cur, *cur.parents):
        if (candidate / "content").is_dir():
            return candidate
    return cur


class AssetManager:
    """(manager.rs:32-192)"""

    def __init__(self, root: "Optional[Path | str]" = None,
                 cache_dir: "Optional[Path | str]" = None):
        self.root = Path(root) if root else find_workspace_root()
        self.content_dir = self.root / "content"
        # Separate cache dir supports read-only content roots.
        self.cache_dir = Path(cache_dir) if cache_dir else self.root / "cache"
        # Hot-reload registry: url → [last seen source mtime, callbacks].
        self._watched: dict = {}

    # -- hot reload ---------------------------------------------------------------

    def watch(self, url: "str | AssetUrl", on_reload=None) -> None:
        """Register a source asset for hot-reload polling. ``on_reload``
        (optional) is called with the fresh MeshCollection handle after a
        rebake. The mtime machinery is the same as _should_bake; polling is
        driven by the engine loop (EngineLoop polls once per stats window)."""
        url = AssetUrl(url) if isinstance(url, str) else url
        source = self.content_dir / url.path
        mtime = source.stat().st_mtime if source.exists() else 0.0
        entry = self._watched.setdefault(url, [mtime, []])
        if on_reload is not None:
            entry[1].append(on_reload)

    def poll_hot_reload(self) -> "list[AssetUrl]":
        """Rebake + re-register every watched asset whose source changed;
        returns the reloaded urls (empty most frames)."""
        reloaded = []
        for url, entry in self._watched.items():
            source = self.content_dir / url.path
            if not source.exists():
                continue
            mtime = source.stat().st_mtime
            if mtime <= entry[0]:
                continue
            entry[0] = mtime
            logger.info("hot-reload: %s changed — rebaking", url)
            handle = self.request_load(url)
            for cb in entry[1]:
                cb(handle)
            reloaded.append(url)
        return reloaded

    @profile.profiled
    def request_load(self, url: "str | AssetUrl") -> "AssetHandle[MeshCollection]":
        """(manager.rs:58-78) Bake-or-load a source asset; returns the
        MeshCollection handle with every referenced asset registered."""
        url = AssetUrl(url) if isinstance(url, str) else url
        manifest_url = url.with_extension("mscl")
        if self._should_bake(url, manifest_url):
            self._bake(url)
        else:
            self._load_cached(manifest_url)
        return registry().handle(manifest_url, MeshCollection)

    # -- internals ---------------------------------------------------------------

    def _should_bake(self, url: AssetUrl, manifest_url: AssetUrl) -> bool:
        """(manager.rs:80-115) cache missing or source newer."""
        source = self.content_dir / url.path
        cached = self.cache_dir / manifest_url.path
        if not cached.exists():
            return True
        if source.exists() and source.stat().st_mtime > cached.stat().st_mtime:
            logger.info("source %s newer than cache — rebaking", url)
            return True
        return False

    @profile.profiled
    def _bake(self, url: AssetUrl) -> None:
        source = self.content_dir / url.path
        if url.path.endswith((".gltf", ".glb")):
            raw = GltfLoader.load(source)
            RawGltfProcessor(raw, url, self.cache_dir).bake()
        else:
            raise ValueError(f"no baker for asset type: {url}")

    @profile.profiled
    def _load_cached(self, manifest_url: AssetUrl) -> None:
        """(manager.rs:136-191) deserialize manifest then recurse."""
        manifest_path = self.cache_dir / manifest_url.path
        collection = MeshCollection.load(manifest_url, manifest_path)
        registry().register(collection)
        for mesh_url in collection.mesh_urls:
            mesh = Mesh.load(AssetUrl(mesh_url), self.cache_dir / mesh_url)
            registry().register(mesh)
        for mat_url in dict.fromkeys(collection.material_urls):
            mat = Material.load(AssetUrl(mat_url), self.cache_dir / mat_url)
            registry().register(mat)
        logger.info(
            "loaded %s from cache (%d meshes)", manifest_url, len(collection.mesh_urls)
        )
