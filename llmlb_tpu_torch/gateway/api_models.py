"""Model registry + HF catalog + per-endpoint model management.

Parity with three reference modules:
- api/models.rs — `POST /api/models/register` pulls a HF repo's file listing
  (safetensors or GGUF), stores metadata + manifest ONLY (no weights,
  :1021-1165), and serves `GET /api/models/registry/:model/manifest.json`
  (:1167) for runtimes to pull from.
- api/catalog.rs — dashboard search over the huggingface.co API (:292) with
  per-endpoint download recommendation (:440-475).
- download/ + delete/ + metadata/ — per-engine model download (Ollama
  `/api/pull` etc.), delete (`/api/delete`), and info (`/api/show`)
  re-proxies, exposed under `/api/endpoints/:id/models/...`.

The HF base URL comes from `HF_BASE_URL` (reference README.md:490) so tests
point it at a mock server; without egress the handlers fail with an explicit
502 rather than hanging.

The port's copy of llmlb_tpu/gateway/api_models.py.
"""

from __future__ import annotations

import asyncio
import os
import time
import uuid

from llmlb_tpu_torch.gateway import http
from llmlb_tpu_torch.gateway.http import web

from llmlb_tpu_torch.gateway.types import EndpointType


def _json_error(status: int, message: str) -> web.Response:
    return web.json_response({"error": message}, status=status)


def hf_base_url() -> str:
    return os.environ.get("HF_BASE_URL", "https://huggingface.co").rstrip("/")


def _hf_headers() -> dict:
    token = os.environ.get("HF_TOKEN")
    return {"Authorization": f"Bearer {token}"} if token else {}


# ---------------------------------------------------------------------------
# Registry (manifest-only model registration)
# ---------------------------------------------------------------------------

def pick_gguf(files: list[str], policy: str = "q4") -> str | None:
    """GGUF pick policy: prefer the requested quant tier, else smallest-ish
    (parity with the reference's policy-based GGUF selection)."""
    ggufs = [f for f in files if f.endswith(".gguf")]
    if not ggufs:
        return None
    preferred = [f for f in ggufs if policy.lower() in f.lower()]
    return sorted(preferred or ggufs)[0]


async def register_model(request: web.Request) -> web.Response:
    """POST /api/models/register {repo, name?, gguf_policy?} — fetch the HF
    repo's sibling file list, build a manifest (no weight download)."""
    state = request.app["state"]
    try:
        body = await request.json()
    except Exception:
        return _json_error(400, "invalid JSON body")
    repo = body.get("repo")
    if not repo or not isinstance(repo, str) or repo.count("/") != 1:
        return _json_error(400, "'repo' must be a HF 'org/name' id")
    name = body.get("name") or repo.split("/", 1)[1]

    url = f"{hf_base_url()}/api/models/{repo}"
    try:
        async with state.http.get(
            url, headers=_hf_headers(),
            timeout=http.ClientTimeout(total=30),
        ) as resp:
            if resp.status == 404:
                return _json_error(404, f"HF repo {repo!r} not found")
            if resp.status != 200:
                return _json_error(502, f"HF API returned {resp.status}")
            info = await resp.json(content_type=None)
    except (http.ClientError, asyncio.TimeoutError, OSError) as e:
        return _json_error(502, f"HF API unreachable: {type(e).__name__}")

    files = [s.get("rfilename", "") for s in info.get("siblings", [])]
    safetensors = [f for f in files if f.endswith(".safetensors")]
    gguf = pick_gguf(files, body.get("gguf_policy", "q4"))
    if safetensors:
        format_ = "safetensors"
        weight_files = sorted(safetensors)
    elif gguf:
        format_ = "gguf"
        weight_files = [gguf]
    else:
        return _json_error(
            422, f"repo {repo!r} contains neither safetensors nor GGUF weights"
        )

    manifest = {
        "name": name,
        "source_repo": repo,
        "format": format_,
        "files": [
            {
                "path": f,
                "url": f"{hf_base_url()}/{repo}/resolve/main/{f}",
            }
            for f in weight_files
            + [f for f in files if f in (
                "config.json", "tokenizer.json", "tokenizer_config.json",
                "tokenizer.model", "generation_config.json",
                "model.safetensors.index.json",
            )]
        ],
        "created_at": time.time(),
    }
    caps = ["embeddings"] if "embed" in name.lower() else ["chat_completion"]
    model_id = state.db.register_model(name, repo, format_, caps, manifest)
    return web.json_response(
        {"id": model_id, "name": name, "format": format_,
         "files": len(manifest["files"])},
        status=201,
    )


async def list_registered_models(request: web.Request) -> web.Response:
    state = request.app["state"]
    return web.json_response({"models": state.db.list_registered_models()})


async def delete_registered_model(request: web.Request) -> web.Response:
    state = request.app["state"]
    name = request.match_info["name"]
    if not state.db.delete_registered_model(name):
        return _json_error(404, f"model {name!r} is not registered")
    return web.json_response({"deleted": name})


async def get_model_manifest(request: web.Request) -> web.Response:
    """GET /api/models/registry/{model}/manifest.json — the pull contract
    runtimes consume (api/models.rs:1167)."""
    state = request.app["state"]
    model = state.db.get_registered_model(request.match_info["model"])
    if model is None or not model.get("manifest"):
        return _json_error(404, "no manifest for this model")
    return web.json_response(model["manifest"])


# ---------------------------------------------------------------------------
# HF catalog search (api/catalog.rs parity)
# ---------------------------------------------------------------------------

async def catalog_search(request: web.Request) -> web.Response:
    """GET /api/catalog/search?q=...&limit=N — HF model search plus, per hit,
    which registered endpoints could serve/download it (catalog.rs:440-475)."""
    state = request.app["state"]
    q = request.query.get("q", "")
    if not q:
        return _json_error(400, "'q' query parameter is required")
    try:
        limit = min(int(request.query.get("limit", "20")), 50)
    except ValueError:
        return _json_error(400, "'limit' must be an integer")

    url = f"{hf_base_url()}/api/models"
    try:
        async with state.http.get(
            url, params={"search": q, "limit": str(limit)},
            headers=_hf_headers(), timeout=http.ClientTimeout(total=30),
        ) as resp:
            if resp.status != 200:
                return _json_error(502, f"HF API returned {resp.status}")
            hits = await resp.json(content_type=None)
    except (http.ClientError, asyncio.TimeoutError, OSError) as e:
        return _json_error(502, f"HF API unreachable: {type(e).__name__}")

    online = state.registry.list_online()
    downloaders = [
        {"endpoint_id": ep.id, "name": ep.name,
         "endpoint_type": ep.endpoint_type.value}
        for ep in online
        if ep.endpoint_type in (EndpointType.OLLAMA, EndpointType.XLLM,
                                EndpointType.LM_STUDIO, EndpointType.TPU)
    ]
    results = []
    for hit in hits if isinstance(hits, list) else []:
        repo = hit.get("modelId") or hit.get("id") or ""
        results.append({
            "repo": repo,
            "downloads": hit.get("downloads", 0),
            "likes": hit.get("likes", 0),
            "tags": hit.get("tags", [])[:8],
            # engine-local name derivation (models/mapping.rs heuristics)
            "ollama_name": repo.split("/")[-1].lower().replace("_", "-"),
            "recommended_endpoints": downloaders,
        })
    return web.json_response({"results": results})


# ---------------------------------------------------------------------------
# Per-endpoint model management (download/ delete/ metadata/ parity)
# ---------------------------------------------------------------------------

_DOWNLOAD_TASKS: dict[str, dict] = {}  # in-memory task store (pruned)
# Strong references to in-flight download asyncio.Tasks: the event loop only
# keeps weak refs, so without this a long pull can be GC'd mid-flight.
_ACTIVE_DOWNLOADS: set[asyncio.Task] = set()


def _prune_tasks(max_tasks: int = 200) -> None:
    if len(_DOWNLOAD_TASKS) > max_tasks:
        evictable = [k for k, t in _DOWNLOAD_TASKS.items()
                     if t["status"] != "running"]
        for key in sorted(evictable,
                          key=lambda k: _DOWNLOAD_TASKS[k]["started_at"])[:50]:
            _DOWNLOAD_TASKS.pop(key, None)


async def download_endpoint_model(request: web.Request) -> web.Response:
    """POST /api/endpoints/{endpoint_id}/models/download {model} — kick a
    pull on the endpoint's engine (Ollama `/api/pull`; generic engines that
    expose `/api/models/download`)."""
    state = request.app["state"]
    ep = state.registry.get(request.match_info["endpoint_id"])
    if ep is None:
        return _json_error(404, "endpoint not found")
    try:
        body = await request.json()
    except Exception:
        return _json_error(400, "invalid JSON body")
    model = body.get("model")
    if not model:
        return _json_error(400, "'model' is required")

    task_id = uuid.uuid4().hex
    task = {
        "id": task_id, "endpoint_id": ep.id, "model": model,
        "status": "running", "progress": 0.0, "error": None,
        "started_at": time.time(),
    }
    _DOWNLOAD_TASKS[task_id] = task
    _prune_tasks()

    async def run():
        try:
            if ep.endpoint_type == EndpointType.OLLAMA:
                path, payload = "/api/pull", {"name": model, "stream": False}
            elif ep.endpoint_type == EndpointType.LM_STUDIO:
                # LM Studio wants a HF URL (download/lm_studio.rs:52-62)
                from llmlb_tpu_torch.gateway.model_names import guess_hf_repo

                repo = guess_hf_repo(model) or model
                hf_url = (repo if repo.startswith("https://")
                          else f"https://huggingface.co/{repo}")
                path, payload = "/api/v1/models/download", {"model": hf_url}
            elif ep.endpoint_type == EndpointType.XLLM:
                # xLLM pulls from HF by repo id (xllm/download.rs:87)
                from llmlb_tpu_torch.gateway.model_names import guess_hf_repo

                path = "/api/models/download"
                payload = {"model": guess_hf_repo(model) or model}
            else:
                path, payload = "/api/models/download", {"model": model}
            headers = {}
            if ep.api_key:
                headers["Authorization"] = f"Bearer {ep.api_key}"
            async with state.http.post(
                ep.url + path, json=payload, headers=headers,
                timeout=http.ClientTimeout(total=3600),
            ) as resp:
                if resp.status >= 400:
                    raise RuntimeError(f"engine returned {resp.status}")
                await resp.read()
            task["status"] = "completed"
            task["progress"] = 1.0
            # refresh the endpoint's model list so the new model is routable
            from llmlb_tpu_torch.gateway.model_sync import sync_endpoint_models

            await sync_endpoint_models(ep, state.registry, state.http)
        except Exception as e:
            task["status"] = "failed"
            task["error"] = str(e)

    t = asyncio.create_task(run())
    _ACTIVE_DOWNLOADS.add(t)
    t.add_done_callback(_ACTIVE_DOWNLOADS.discard)
    return web.json_response({"task_id": task_id}, status=202)


async def download_progress(request: web.Request) -> web.Response:
    task = _DOWNLOAD_TASKS.get(request.match_info["task_id"])
    if task is None:
        return _json_error(404, "unknown download task")
    return web.json_response(task)


async def delete_endpoint_model(request: web.Request) -> web.Response:
    """DELETE /api/endpoints/{endpoint_id}/models/{model} (Ollama
    `/api/delete`; generic engines' DELETE /api/models/{model})."""
    state = request.app["state"]
    ep = state.registry.get(request.match_info["endpoint_id"])
    if ep is None:
        return _json_error(404, "endpoint not found")
    model = request.match_info["model"]
    headers = {}
    if ep.api_key:
        headers["Authorization"] = f"Bearer {ep.api_key}"
    try:
        if ep.endpoint_type == EndpointType.OLLAMA:
            resp = await state.http.delete(
                ep.url + "/api/delete", json={"name": model}, headers=headers,
                timeout=http.ClientTimeout(total=60),
            )
        else:
            resp = await state.http.delete(
                ep.url + f"/api/models/{model}", headers=headers,
                timeout=http.ClientTimeout(total=60),
            )
        status = resp.status
        resp.release()
    except (http.ClientError, asyncio.TimeoutError, OSError) as e:
        return _json_error(502, f"endpoint unreachable: {type(e).__name__}")
    if status >= 400:
        return _json_error(502, f"engine refused delete ({status})")
    from llmlb_tpu_torch.gateway.model_sync import sync_endpoint_models

    try:
        await sync_endpoint_models(ep, state.registry, state.http)
    except Exception:  # allow-silent: best-effort resync; the periodic
        pass           # sync loop reconciles on its next pass
    return web.json_response({"deleted": model})


async def endpoint_model_info(request: web.Request) -> web.Response:
    """GET /api/endpoints/{endpoint_id}/models/{model}/info (Ollama
    `/api/show` parity; others get the synced registry record)."""
    state = request.app["state"]
    ep = state.registry.get(request.match_info["endpoint_id"])
    if ep is None:
        return _json_error(404, "endpoint not found")
    model = request.match_info["model"]
    if ep.endpoint_type == EndpointType.OLLAMA:
        headers = {}
        if ep.api_key:
            headers["Authorization"] = f"Bearer {ep.api_key}"
        try:
            async with state.http.post(
                ep.url + "/api/show", json={"name": model}, headers=headers,
                timeout=http.ClientTimeout(total=30),
            ) as resp:
                if resp.status == 200:
                    return web.json_response(await resp.json(content_type=None))
        except (http.ClientError, asyncio.TimeoutError, OSError):
            pass
    for m in state.registry.models_for(ep.id):
        if m.model_id == model or m.canonical_name == model:
            return web.json_response({
                "model": m.model_id,
                "canonical_name": m.canonical_name,
                "capabilities": [c.value for c in m.capabilities],
                "context_length": m.context_length,
            })
    return _json_error(404, f"model {model!r} not found on endpoint")


async def playground_chat_proxy(request: web.Request) -> web.Response:
    """POST /api/endpoints/{endpoint_id}/chat/completions — dashboard
    playground pinned-endpoint proxy (reference api/endpoints.rs:1079,
    route-gated as inference in api/mod.rs:460-479)."""
    state = request.app["state"]
    ep = state.registry.get(request.match_info["endpoint_id"])
    if ep is None:
        return _json_error(404, "endpoint not found")
    try:
        body = await request.json()
    except Exception:
        return _json_error(400, "invalid JSON body")
    body["stream"] = False  # playground uses non-stream responses
    headers = {}
    if ep.api_key:
        headers["Authorization"] = f"Bearer {ep.api_key}"
    try:
        async with state.http.post(
            ep.url + "/v1/chat/completions", json=body, headers=headers,
            timeout=http.ClientTimeout(total=state.config.inference_timeout_s),
        ) as resp:
            raw = await resp.read()
            return web.Response(
                body=raw, status=resp.status,
                content_type=(resp.headers.get("Content-Type", "application/json")
                              .split(";")[0]),
            )
    except (http.ClientError, asyncio.TimeoutError, OSError) as e:
        return _json_error(502, f"endpoint unreachable: {type(e).__name__}")
