"""HTTP inference server over a ServingModel (counterpart of
`xggm_tpu/serving/server.py`; the same endpoints and response shapes).

Request path: tokenize the questions -> gather image features by img_id ->
pad to the artifact's batch size -> encoder + answer head -> answer strings.

    GET  /healthz    -> {"status": "ok", "batch_size", "num_answers",
                         "platforms", "jax_version", "device"}
    POST /predict    body {"queries": [{"img_id": ..., "sent": ...}, ...]}
                     -> {"answers": [...], "latency_ms": float}

stdlib only (http.server); requests larger than the batch size are chunked.
"""
from __future__ import annotations

import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List

import numpy as np

from xggm_tpu_torch.config import MAX_SEQ_LENGTH
from xggm_tpu_torch.data.tokenizer import BertTokenizer, encode_batch
from xggm_tpu_torch.serving.artifact import ServingModel


class InferenceEngine:
    """ServingModel + tokenizer + feature store: queries in, answers out."""

    def __init__(self, model: ServingModel, tokenizer: BertTokenizer, store):
        self.model = model
        self.tokenizer = tokenizer
        self.store = store

    def _assemble(self, queries: List[Dict]) -> Dict[str, np.ndarray]:
        ids, mask, seg = encode_batch(
            self.tokenizer, (q["sent"] for q in queries),
            self.model.meta.get("seq_len", MAX_SEQ_LENGTH))
        n = len(queries)
        feat_dim = self.model.meta["feat_dim"]
        n_obj = self.model.meta["num_objects"]
        feats = np.empty((n, n_obj, feat_dim), np.float32)
        boxes = np.empty((n, n_obj, 4), np.float32)
        for i, q in enumerate(queries):
            f, b, _adj = self.store.get(q["img_id"])
            feats[i], boxes[i] = f, b
        return {"input_ids": ids, "input_mask": mask, "segment_ids": seg,
                "feats": feats, "boxes": boxes}

    def answer(self, queries: List[Dict]) -> List[str]:
        bs = self.model.batch_size or len(queries)
        out: List[str] = []
        for start in range(0, len(queries), bs):
            chunk = queries[start:start + bs]
            out.extend(self.model.predict_answers(self._assemble(chunk)))
        return out


def _parse_queries(body: bytes) -> List[Dict]:
    req = json.loads(body or b"{}")
    queries = req.get("queries") if isinstance(req, dict) else None
    if not isinstance(queries, list) or not queries:
        raise ValueError("queries must be a non-empty list")
    for q in queries:
        if not isinstance(q, dict) or "img_id" not in q or "sent" not in q:
            raise ValueError("each query needs img_id and sent")
    return queries


def make_server(engine: InferenceEngine, host: str = "127.0.0.1",
                port: int = 8000) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                meta = engine.model.meta
                self._send(200, {
                    "status": "ok",
                    "batch_size": meta["batch_size"],
                    "num_answers": meta["num_answers"],
                    "platforms": meta.get("platforms"),
                    "jax_version": meta.get("jax_version"),
                    "device": str(engine.model.device),
                })
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                queries = _parse_queries(self.rfile.read(length))
                t0 = time.perf_counter()
                answers = engine.answer(queries)
                ms = (time.perf_counter() - t0) * 1e3
                self._send(200, {"answers": answers, "latency_ms": ms})
            except Exception as e:  # the boundary: report as JSON, keep serving
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):
            pass

    return ThreadingHTTPServer((host, port), Handler)
