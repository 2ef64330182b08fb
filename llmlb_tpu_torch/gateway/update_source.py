"""Self-update sources and appliers: GitHub Releases check, asset download
with progress, artifact swap with `.bak` rollback, restart marker.

The port's copy of llmlb_tpu/gateway/update_source.py, on the port's HTTP
client (gateway/http.py) in place of aiohttp. Parity with reference
update/mod.rs internals: release check with a 24 h cache (:965+), asset
download with progress reporting, platform apply that keeps a `.bak` of the
previous binary, and the 30 s post-restart health watch with automatic
rollback (README.md:160-166). The swap unit here is an operator-configured
artifact path (the deployable the supervisor re-execs — a zipapp/venv
tarball/binary), not a Rust binary, but the lifecycle and the on-disk
`.bak` + marker contract are the same, and equal to the JAX package's: a
marker or a `.bak` that either package wrote is read by the other.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time

from llmlb_tpu_torch.gateway.http import ClientSession, ClientTimeout

log = logging.getLogger("llmlb_tpu_torch.gateway.update")

CHECK_CACHE_S = 24 * 3600.0  # parity: 24h release-check cache
MARKER_NAME = "update_pending.json"


def _version_tuple(v: str) -> tuple:
    parts = []
    for tok in v.lstrip("v").replace("-", ".").split("."):
        parts.append(int(tok) if tok.isdigit() else -1)
    return tuple(parts)


def is_newer(candidate: str, current: str) -> bool:
    try:
        return _version_tuple(candidate) > _version_tuple(current)
    except Exception:
        return candidate != current


class GitHubUpdateSource:
    """Release check + asset download against the GitHub Releases API."""

    def __init__(
        self,
        http: ClientSession,
        repo: str,
        current_version: str,
        asset_match: str = "",
        api_base: str = "https://api.github.com",
    ):
        self.http = http
        self.repo = repo
        self.current_version = current_version
        self.asset_match = asset_match  # substring an asset name must contain
        self.api_base = api_base.rstrip("/")
        self._cache: dict | None = None
        self._cache_at = 0.0

    async def check(self, force: bool = False) -> dict | None:
        """Latest-release probe; None when current is up to date. Results are
        cached for CHECK_CACHE_S unless force (update/mod.rs 24h cache)."""
        now = time.time()
        if not force and self._cache is not None and (
            now - self._cache_at < CHECK_CACHE_S
        ):
            release = self._cache
        else:
            url = f"{self.api_base}/repos/{self.repo}/releases/latest"
            async with self.http.get(
                url,
                headers={"Accept": "application/vnd.github+json"},
                timeout=ClientTimeout(total=30),
            ) as resp:
                if resp.status != 200:
                    raise RuntimeError(
                        f"release check failed: HTTP {resp.status}"
                    )
                release = await resp.json()
            self._cache, self._cache_at = release, now

        version = (release.get("tag_name") or "").strip()
        if not version or not is_newer(version, self.current_version):
            return None
        asset_url = None
        asset_name = None
        for asset in release.get("assets") or []:
            name = asset.get("name") or ""
            if self.asset_match in name:
                asset_url = asset.get("browser_download_url")
                asset_name = name
                break
        return {
            "version": version,
            "asset_url": asset_url,
            "asset_name": asset_name,
            "notes": (release.get("body") or "")[:2000],
        }

    async def download(
        self, url: str, dest_path: str, progress_cb=None,
        chunk_size: int = 1 << 16,
    ) -> str:
        """Stream the asset to dest_path, reporting (done, total) progress."""
        tmp = dest_path + ".part"
        async with self.http.get(
            url, timeout=ClientTimeout(total=3600, sock_read=120)
        ) as resp:
            if resp.status != 200:
                raise RuntimeError(f"asset download failed: HTTP {resp.status}")
            total = int(resp.headers.get("Content-Length") or 0)
            done = 0
            with open(tmp, "wb") as f:
                async for chunk in resp.content.iter_chunked(chunk_size):
                    f.write(chunk)
                    done += len(chunk)
                    if progress_cb:
                        progress_cb(done, total)
        os.replace(tmp, dest_path)
        return dest_path


class ArtifactSwapApplier:
    """Swap the deployable artifact in place, keeping `.bak` for rollback.

    apply(): current → current.bak, staged → current, write the restart
    marker. The supervisor (systemd/k8s/launchd) restarts the process; on
    next boot `post_restart_watch` clears the marker when healthy or rolls
    back from `.bak` when not (reference update apply + rollback flow).
    """

    def __init__(self, artifact_path: str, state_dir: str | None = None):
        self.artifact_path = artifact_path
        self.state_dir = state_dir or os.path.dirname(
            os.path.abspath(artifact_path)
        )
        os.makedirs(self.state_dir, exist_ok=True)

    @property
    def backup_path(self) -> str:
        return self.artifact_path + ".bak"

    @property
    def marker_path(self) -> str:
        return os.path.join(self.state_dir, MARKER_NAME)

    def apply(self, staged_path: str, version: str | None) -> None:
        if not os.path.isfile(staged_path):
            raise FileNotFoundError(staged_path)
        mode = None
        if os.path.isfile(self.artifact_path):
            shutil.copy2(self.artifact_path, self.backup_path)
            mode = os.stat(self.artifact_path).st_mode
        # shutil.move, not os.replace: the staging dir may be on another
        # filesystem (os.replace raises EXDEV across devices).
        shutil.move(staged_path, self.artifact_path)
        if mode is not None:
            os.chmod(self.artifact_path, mode)
        self.write_marker(version)

    def write_marker(self, version: str | None) -> None:
        with open(self.marker_path, "w") as f:
            json.dump({
                "version": version,
                "applied_at": time.time(),
                "artifact": self.artifact_path,
                "backup": self.backup_path,
            }, f)

    def read_marker(self) -> dict | None:
        try:
            with open(self.marker_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def clear_marker(self) -> None:
        try:
            os.unlink(self.marker_path)
        except OSError:
            pass

    def rollback(self) -> bool:
        """Restore the previous artifact from `.bak`. True if restored."""
        if not os.path.isfile(self.backup_path):
            return False
        os.replace(self.backup_path, self.artifact_path)
        self.clear_marker()
        return True
