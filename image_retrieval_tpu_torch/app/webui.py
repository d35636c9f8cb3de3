"""Thin web UI — port of ``image_retrieval_tpu/app/webui.py``.

A browser front end over the micro-batching SearchServer on the standard
library's http.server: a query box, a grid of results with scores, a JSON
API.

    python -m image_retrieval_tpu_torch.app.webui --folder ./photos
    python -m image_retrieval_tpu_torch.app.webui --folder ./photos --device cpu --fake-encoder
    # then open http://localhost:8008

Endpoints:
    GET  /                          HTML page
    GET  /search?q=...&k=10         JSON [{path, score}]
         &metric=optimized&w_l1=1&w_l2=1&w_inf=0&w_mag=0.5&w_angle=1
         &filter=dir == 'red'
    GET  /similar?path=...&k=10     image query: the gallery ranked by
                                    similarity to an indexed image, itself
                                    excluded (click a thumbnail in the UI)
    POST /batch_search              JSON {"queries": [...], "k": 10} ->
                                    JSON [[{path, score}], ...]
    POST /add                       JSON {"paths": [...]}: live ingest
    POST /remove                    JSON {"paths": [...]}: live delete
    GET  /image?path=...            the image file (only paths in the index)
    GET  /stats                     JSON serving counters

/search, /similar and /batch_search take `approx` (&approx=1/0, or
"approx": true/false in the JSON body), as does the command line
(--approx-select): validated and accepted, the answers are exact (the
JAX package's approximate selector is exact off a TPU). --ann ivf serves
unfiltered queries from an IVF over the index (--nlist, --nprobe; 0 =
auto; /add and /remove keep it), --ann screen from a projection screen.
"""

from __future__ import annotations

import argparse
import json
import logging
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


logger = logging.getLogger(__name__)

_PAGE = """<!doctype html>
<html><head><title>image-retrieval</title><style>
body{font-family:sans-serif;margin:2em;background:#fafafa}
#grid{display:flex;flex-wrap:wrap;gap:12px;margin-top:1em}
.card{background:#fff;border:1px solid #ddd;border-radius:6px;padding:6px;width:190px}
.card img{width:180px;height:180px;object-fit:contain}
.score{font-size:12px;color:#555;word-break:break-all}
input{font-size:16px;padding:6px;width:24em}
button{font-size:16px;padding:6px 14px}
</style></head><body>
<h2>image-retrieval</h2>
<form onsubmit="go();return false">
<input id=q placeholder="a brown dog" autofocus>
<input id=f placeholder="filter e.g. dir == 'red'" style="width:16em">
<button>Search</button></form>
<div id=grid></div>
<script>
function render(hits){
  document.getElementById('grid').innerHTML=hits.map(h=>
    `<div class=card><img src="/image?path=${encodeURIComponent(h.path)}"`+
    ` onclick="similar('${encodeURIComponent(h.path)}')" title="find similar"`+
    ` style="cursor:pointer">`+
    `<div class=score>${h.score.toFixed(4)}<br>${h.path.split('/').pop()}</div></div>`
  ).join('');
}
function fexpr(){
  const f=document.getElementById('f').value.trim();
  return f?'&filter='+encodeURIComponent(f):'';
}
async function go(){
  const q=document.getElementById('q').value;
  const r=await fetch('/search?q='+encodeURIComponent(q)+'&k=12'+fexpr());
  render(await r.json());
}
async function similar(p){
  const r=await fetch('/similar?path='+p+'&k=12'+fexpr());
  render(await r.json());
}
</script></body></html>"""

#: per-request wait budget: the first request of a process loads the
#: kernels and stages the gallery on the device
_SEARCH_TIMEOUT_S = 120.0


class _Handler(BaseHTTPRequestHandler):
    server_ctx = None  # set by serve()

    def log_message(self, fmt, *args):
        logger.debug(fmt % args)

    def _send(self, code, body, ctype="text/html"):
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            logger.debug("client disconnected before the response was sent")

    def _json(self, code, obj):
        self._send(code, json.dumps(obj).encode(), "application/json")

    @staticmethod
    def _parse_weights(qs):
        """The five optimized-similarity weights from the query string."""
        return {key: float((qs.get(key) or [default])[0])
                for key, default in (("w_angle", "1"), ("w_l1", "0"), ("w_l2", "0"),
                                     ("w_inf", "0"), ("w_mag", "0"))}

    @staticmethod
    def _parse_approx(qs):
        """&approx=1/0 -> True/False; absent -> None. Anything else is a
        400, not a silent True."""
        raw = (qs.get("approx") or [None])[0]
        if raw is None:
            return None
        low = raw.lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off", ""):
            return False
        raise ValueError(f"bad approx value {raw!r} (use 1/0)")

    def _metric_kwargs(self, qs):
        metric = (qs.get("metric") or ["cosine"])[0]
        flt = (qs.get("filter") or [None])[0] or None
        kw = {"flt": flt, "approx": self._parse_approx(qs), "timeout": _SEARCH_TIMEOUT_S}
        if metric.startswith("optimized"):
            kw.update(metric="optimized_similarity", weights=self._parse_weights(qs))
        return kw

    def do_GET(self):
        ctx = self.server_ctx
        parsed = urllib.parse.urlparse(self.path)
        qs = urllib.parse.parse_qs(parsed.query)
        if parsed.path in ("/search", "/similar"):
            k = int((qs.get("k") or ["10"])[0])
        if parsed.path == "/":
            self._send(200, _PAGE.encode())
        elif parsed.path == "/search":
            query = (qs.get("q") or [""])[0]
            if not query.strip():
                self._send(400, b"[]", "application/json")
                return
            try:
                results = ctx["server"].search(query, top_k=k, **self._metric_kwargs(qs))
            except Exception as e:  # a bad filter expression is the client's error
                self._json(400, {"error": str(e)})
                return
            self._json(200, results)
        elif parsed.path == "/similar":
            path = (qs.get("path") or [""])[0]
            if path not in ctx["known_paths"]:
                self._send(404, b"not found", "text/plain")
                return
            try:
                results = ctx["server"].search_similar(path, top_k=k, **self._metric_kwargs(qs))
            except Exception as e:
                self._json(400, {"error": str(e)})
                return
            self._json(200, results)
        elif parsed.path == "/stats":
            stats = dict(ctx["server"].stats)
            stats["indexed_images"] = len(ctx["known_paths"])
            self._json(200, stats)
        elif parsed.path == "/image":
            path = (qs.get("path") or [""])[0]
            if path not in ctx["known_paths"]:
                self._send(404, b"not found", "text/plain")
                return
            try:
                with open(path, "rb") as f:
                    data = f.read()
                self._send(200, data, "image/png" if path.endswith(".png") else "image/jpeg")
            except OSError:
                self._send(404, b"not found", "text/plain")
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self):
        ctx = self.server_ctx
        length = int(self.headers.get("Content-Length", 0))
        try:
            body = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, TypeError):
            self._send(400, b"bad request", "text/plain")
            return
        try:
            if self.path == "/batch_search":
                # enqueue every query before waiting: they share micro-batches
                approx = body.get("approx")
                if approx is not None and not isinstance(approx, bool):
                    raise ValueError(f"bad approx value {approx!r} (use true/false)")
                out = ctx["server"].search_many(list(body.get("queries") or []),
                                                top_k=int(body.get("k", 10)), approx=approx,
                                                timeout=_SEARCH_TIMEOUT_S)
                self._json(200, out)
            elif self.path == "/add":
                paths = [str(p) for p in (body.get("paths") or [])]
                ok, failed = ctx["server"].add_images(paths)
                indexed = set(ctx["server"].index.paths)
                ctx["known_paths"].update(p for p in paths if p in indexed)
                self._json(200, {"inserted": ok, "failed": failed})
            elif self.path == "/remove":
                paths = [str(p) for p in (body.get("paths") or [])]
                n = ctx["server"].remove_images(paths)
                ctx["known_paths"].difference_update(paths)
                self._json(200, {"removed": n})
            else:
                self._send(404, b"not found", "text/plain")
        except Exception as e:
            self._json(400, {"error": str(e)})


def serve(search_server, known_paths, host: str = "127.0.0.1", port: int = 8008):
    """The HTTP server over `search_server` (not yet serving: call
    serve_forever(), e.g. in a thread). port=0 binds an ephemeral port
    (httpd.server_address has it)."""
    handler = type("Handler", (_Handler,), {
        "server_ctx": {"server": search_server, "known_paths": set(known_paths)}})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--folder", required=True)
    ap.add_argument("--fake-encoder", "--fake_encoder", dest="fake_encoder",
                    action="store_true")
    ap.add_argument("--journal-dir", "--journal_dir", dest="journal_dir", default=None,
                    help="Durable index directory: rows recovered on start, mutations "
                         "write-ahead logged, so POST /add survives a restart")
    ap.add_argument("--device", default=None,
                    help="Device of the index and the encoder (cuda:1, cpu); default: "
                         "every visible card")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--ann", choices=("exact", "ivf", "screen"), default="exact",
                    help="Candidate generation: the exact index, an IVF over it "
                         "(the reference's Milvus IVF_FLAT) or a projection screen")
    ap.add_argument("--nlist", type=int, default=1024, help="--ann ivf: clusters (0 = auto)")
    ap.add_argument("--nprobe", type=int, default=10,
                    help="--ann ivf: clusters probed per query (0 = auto)")
    ap.add_argument("--screen-dims", "--screen_dims", dest="screen_dims", type=int,
                    default=128)
    ap.add_argument("--screen-candidates", "--screen_candidates", dest="screen_candidates",
                    type=int, default=128)
    ap.add_argument("--approx-select", "--approx_select", dest="approx_select",
                    action="store_true",
                    help="Accepted for the JAX web UI's command line; the answers "
                         "are exact")
    args = ap.parse_args(argv)

    from image_retrieval_tpu_torch.app.pipeline import ImageSearchApp
    from image_retrieval_tpu_torch.app.server import SearchServer
    from image_retrieval_tpu_torch.models.encoder import get_encoder

    encoder = get_encoder(fake=True) if args.fake_encoder else None
    app = ImageSearchApp(encoder=encoder, journal_dir=args.journal_dir, device=args.device)
    app.config.search.ann = args.ann
    app.config.search.nlist = args.nlist
    app.config.search.nprobe = args.nprobe
    app.config.search.screen_dims = args.screen_dims
    app.config.search.screen_candidates = args.screen_candidates
    app.process_images(app.scan_folders(args.folder))
    index = app._ensure_index()
    if index is None or len(index) == 0:
        raise SystemExit(f"no images found under {args.folder!r}: nothing to serve")
    with SearchServer(app._get_encoder(), index, ann=app._ensure_ann(index),
                      overfetch=app.config.search.overfetch,
                      approx_select=True if args.approx_select else None) as srv:
        httpd = serve(srv, index.paths, args.host, args.port)
        print(f"Serving {len(index)} images at http://{args.host}:{args.port}")
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()


if __name__ == "__main__":
    main()
