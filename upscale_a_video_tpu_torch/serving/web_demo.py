"""Browser demo server: a single page and a JSON API in front of the
controller and its workers.

Port of ``upscale_a_video_tpu/serving/web_demo.py`` (the reference LLaVA
serving's gradio web server, rebuilt with the standard library):

    GET  /               the page (upload or name a video; -n, -g, -s, -p, colour fix)
    POST /list_models    the controller's /list_workers
    POST /upscale        {video_path | video_b64 + filename, noise_level,
                         guidance_scale, inference_steps, propagation_steps,
                         color_fix, caption?, seed?, segment_frames?}
                         → controller /get_worker →
                         worker /predict → {output, job_id}; with
                         "stream": true, chunked NDJSON: {job_id, worker},
                         the worker's {"progress": ...} lines, then the result
    POST /caption        {image_b64} → the caption service
                         (``UAV_CAPTION_ENDPOINT``) → {caption}
    GET  /file?path=...  a produced file, only from inside the work directory
    GET  /jobs           running and recent jobs, newest first

A server-side ``video_path`` must lie inside the work directory too. Every
job is appended to a per-day JSONL log in the log directory.

    python -m upscale_a_video_tpu_torch.serving.web_demo --port 7860 \
        --controller http://localhost:21001
"""

from __future__ import annotations

import base64
import json
import os
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>Upscale-A-Video</title>
<style>
 body{font-family:sans-serif;max-width:760px;margin:2em auto;padding:0 1em}
 fieldset{margin:1em 0;border:1px solid #ccc;border-radius:6px}
 label{display:inline-block;min-width:11em;margin:.25em 0}
 input[type=number],input[type=text]{width:10em}
 #out video{max-width:100%}
 #status{color:#666}
</style></head><body>
<h2>Upscale-A-Video &mdash; demo</h2>
<fieldset><legend>Workers</legend>
 <button onclick="refresh()">Refresh</button> <span id="models"></span>
</fieldset>
<fieldset><legend>Input</legend>
 <label>Video file</label><input type="file" id="file" accept="video/*"><br>
 <label>&hellip;or server path</label><input type="text" id="path"><br>
 <label>Caption (optional)</label><input type="text" id="caption" size="40">
</fieldset>
<fieldset><legend>Settings</legend>
 <label>Noise level (-n)</label><input type="number" id="n" value="150"><br>
 <label>Guidance (-g)</label><input type="number" id="g" value="6" step="0.5"><br>
 <label>Steps (-s)</label><input type="number" id="s" value="30"><br>
 <label>Propagation (-p)</label><input type="text" id="p" placeholder="24,26,28"><br>
 <label>Color fix</label><select id="cf"><option>None</option>
   <option>AdaIn</option><option>Wavelet</option></select>
</fieldset>
<button onclick="go()">Upscale</button> <span id="status"></span>
<div id="out"></div>
<script>
async function refresh(){
 const r = await fetch('/list_models',{method:'POST'});
 document.getElementById('models').textContent = JSON.stringify(await r.json());
}
function b64(file){return new Promise((res,rej)=>{const fr=new FileReader();
 fr.onload=()=>res(fr.result.split(',')[1]);fr.onerror=rej;
 fr.readAsDataURL(file);});}
async function go(){
 const st=document.getElementById('status');st.textContent='starting…';
 const body={stream:true,noise_level:+document.getElementById('n').value,
  guidance_scale:+document.getElementById('g').value,
  inference_steps:+document.getElementById('s').value,
  propagation_steps:document.getElementById('p').value,
  color_fix:document.getElementById('cf').value,
  caption:document.getElementById('caption').value||null};
 const f=document.getElementById('file').files[0];
 if(f){body.video_b64=await b64(f);body.filename=f.name;}
 else body.video_path=document.getElementById('path').value;
 const r=await fetch('/upscale',{method:'POST',body:JSON.stringify(body)});
 const reader=r.body.getReader();const dec=new TextDecoder();let buf='';let j={};
 for(;;){const {done,value}=await reader.read();if(done)break;
  buf+=dec.decode(value,{stream:true});
  let nl;while((nl=buf.indexOf('\n'))>=0){
   const line=buf.slice(0,nl).trim();buf=buf.slice(nl+1);
   if(!line)continue;const ev=JSON.parse(line);
   if(ev.progress)st.textContent=ev.progress.stage+' '+ev.progress.i+
     (ev.progress.n>0?'/'+ev.progress.n:'');
   else j=ev;
  }}
 if(j.output){st.textContent='done';
  document.getElementById('out').innerHTML=
   '<video controls src="/file?path='+encodeURIComponent(j.output)+'"></video>';
 } else st.textContent='error: '+(j.error||r.status);
}
refresh();
</script></body></html>"""


class WebDemo:
    def __init__(self, controller_url: str,
                 caption_endpoint: Optional[str] = None,
                 work_dir: Optional[str] = None,
                 log_dir: Optional[str] = None):
        self.controller_url = controller_url
        self.caption_endpoint = caption_endpoint or os.environ.get(
            "UAV_CAPTION_ENDPOINT")
        self.work_dir = os.path.abspath(
            work_dir or tempfile.mkdtemp(prefix="uav_webdemo_"))
        os.makedirs(self.work_dir, exist_ok=True)
        self.log_dir = log_dir or self.work_dir
        self.lock = threading.Lock()
        self._jobs: dict = {}          # job_id → status record
        self._next_job = 0

    # ------------------------------------------------------------- helpers

    def _post(self, url: str, payload: dict, timeout: float = 3600.0) -> dict:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())

    def _log(self, record: dict) -> None:
        """Append to a per-day JSONL (ref gradio_web_server.py
        ``get_conv_log_filename`` / ``vote_last_response`` logging)."""
        name = time.strftime("%Y-%m-%d") + "-demo.jsonl"
        with self.lock, open(os.path.join(self.log_dir, name), "a") as f:
            f.write(json.dumps({"tstamp": time.time(), **record}) + "\n")

    # ----------------------------------------------------------- endpoints

    def list_models(self) -> dict:
        try:
            return self._post(self.controller_url + "/list_workers", {},
                              timeout=10)
        except Exception as e:
            return {"error": f"controller unreachable: {e}"}

    def _prepare_job(self, data: dict):
        """Validate + stage the input; returns (kwargs, None) or (None, err)."""
        video_path = data.get("video_path")
        if video_path and not self.file_ok(video_path):
            # server-side paths are restricted to the demo work dir —
            # an arbitrary path would let any reachable client feed any
            # worker-readable file into the pipeline
            return None, {"error": "video_path must be inside the demo work dir"}
        if not video_path and data.get("video_b64"):
            fname = os.path.basename(data.get("filename") or "upload.mp4")
            video_path = os.path.join(self.work_dir, f"{int(time.time())}_{fname}")
            with open(video_path, "wb") as f:
                f.write(base64.b64decode(data["video_b64"]))
        if not video_path or not os.path.exists(video_path):
            return None, {"error": "no input video"}

        p = data.get("propagation_steps") or ()
        if isinstance(p, str):
            p = [int(x) for x in p.replace(" ", "").split(",") if x]
        kwargs = {
            "video_path": video_path,
            "output_path": os.path.join(self.work_dir, "results"),
            "noise_level": int(data.get("noise_level", 150)),
            "guidance_scale": float(data.get("guidance_scale", 6.0)),
            "inference_steps": int(data.get("inference_steps", 30)),
            "propagation_steps": list(p),
            "color_fix": data.get("color_fix", "None"),
        }
        if data.get("caption"):
            kwargs["caption"] = data["caption"]
        # the seed and the streaming mode, when the request sets them (the
        # JAX demo forwards neither)
        for key in ("seed", "segment_frames"):
            if data.get(key) is not None:
                kwargs[key] = int(data[key])
        return kwargs, None

    def _pick_worker(self):
        try:
            got = self._post(self.controller_url + "/get_worker", {},
                             timeout=10)
        except urllib.error.HTTPError as e:  # the controller answers 404 without workers
            if e.code == 404:
                return None, {"error": "no workers available"}
            return None, {"error": f"controller failed: {e}"}
        except Exception as e:
            return None, {"error": f"controller unreachable: {e}"}
        return got["url"], None

    def _open_job(self, worker_url: str) -> int:
        with self.lock:
            job_id = self._next_job
            self._next_job += 1
            self._jobs[job_id] = {"id": job_id, "status": "running",
                                  "worker": worker_url,
                                  "started": time.time()}
        return job_id

    def _close_job(self, job_id: int, kwargs: dict, worker_url: str,
                   result: dict) -> dict:
        with self.lock:
            self._jobs[job_id].update(
                status="done" if "output" in result else "error",
                finished=time.time())
        self._log({"type": "upscale", "worker": worker_url,
                   "params": {k: v for k, v in kwargs.items()
                              if k != "video_path"},
                   "ok": "output" in result})
        return dict(result, job_id=job_id)

    def upscale(self, data: dict) -> dict:
        kwargs, err = self._prepare_job(data)
        if err:
            return err
        worker_url, err = self._pick_worker()
        if err:
            return err
        job_id = self._open_job(worker_url)
        try:
            result = self._post(worker_url + "/predict", kwargs)
        except Exception as e:
            result = {"error": f"worker failed: {e}"}
        return self._close_job(job_id, kwargs, worker_url, result)

    def upscale_stream(self, data: dict, emit) -> None:
        """Streaming upscale: forwards the worker's chunked NDJSON progress
        lines through ``emit(event_dict)``, updating the job registry live
        (replaces polling-only progress; the reference demo's streaming
        chatbot analog)."""
        kwargs, err = self._prepare_job(data)
        if err is None:
            worker_url, err = self._pick_worker()
        if err:
            emit(err)
            return
        job_id = self._open_job(worker_url)
        emit({"job_id": job_id, "worker": worker_url})
        result = {"error": "worker stream ended unexpectedly"}
        try:
            req = urllib.request.Request(
                worker_url + "/predict",
                data=json.dumps(dict(kwargs, stream=True)).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=3600) as resp:
                for line in resp:  # chunked NDJSON, one event per line
                    line = line.strip()
                    if not line:
                        continue
                    ev = json.loads(line)
                    if "progress" in ev:
                        with self.lock:
                            self._jobs[job_id]["progress"] = ev["progress"]
                        emit(ev)
                    else:
                        result = ev
        except Exception as e:
            result = {"error": f"worker failed: {e}"}
        emit(self._close_job(job_id, kwargs, worker_url, result))

    def jobs(self) -> dict:
        """In-flight and recent jobs (polling progress, most recent first)."""
        with self.lock:
            recent = sorted(self._jobs.values(), key=lambda j: -j["id"])[:20]
        return {"jobs": recent}

    def caption(self, data: dict) -> dict:
        if not self.caption_endpoint:
            return {"error": "no caption endpoint configured"}
        try:
            return self._post(self.caption_endpoint,
                              {"image_b64": data.get("image_b64", "")},
                              timeout=300)
        except Exception as e:
            return {"error": f"caption worker unreachable: {e}"}

    def file_ok(self, path: str) -> bool:
        """Only files under the demo work dir are served back."""
        real = os.path.realpath(path)
        return real.startswith(os.path.realpath(self.work_dir) + os.sep) \
            and os.path.isfile(real)


def make_handler(demo: WebDemo):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # chunked responses need 1.1

        def log_message(self, *args):
            pass

        def _stream_upscale(self, data: dict):
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def emit(ev: dict):
                payload = json.dumps(ev).encode() + b"\n"
                try:
                    self.wfile.write(
                        f"{len(payload):X}\r\n".encode() + payload + b"\r\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client gone; keep draining the worker stream

            demo.upscale_stream(data, emit)
            try:
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path == "/":
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif parsed.path == "/file":
                q = urllib.parse.parse_qs(parsed.query)
                path = (q.get("path") or [""])[0]
                if not demo.file_ok(path):
                    self._json(404, {"error": "not found"})
                    return
                with open(path, "rb") as f:
                    data = f.read()
                self.send_response(200)
                self.send_header("Content-Type", "video/mp4")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif parsed.path == "/jobs":
                self._json(200, demo.jobs())
            else:
                self._json(404, {"error": "unknown endpoint"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                data = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(data, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request body: {e}"})
                return
            if self.path == "/list_models":
                self._json(200, demo.list_models())
            elif self.path == "/upscale":
                if data.pop("stream", False):
                    self._stream_upscale(data)
                    return
                result = demo.upscale(data)
                self._json(200 if "output" in result else 500, result)
            elif self.path == "/caption":
                result = demo.caption(data)
                self._json(200 if "caption" in result else 500, result)
            else:
                self._json(404, {"error": "unknown endpoint"})

    return Handler


def serve_web_demo(host: str = "127.0.0.1", port: int = 7860,
                   controller_url: str = "http://localhost:21001",
                   caption_endpoint: Optional[str] = None,
                   work_dir: Optional[str] = None) -> ThreadingHTTPServer:
    demo = WebDemo(controller_url, caption_endpoint, work_dir)
    server = ThreadingHTTPServer((host, port), make_handler(demo))
    server.demo = demo  # type: ignore[attr-defined]
    return server


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    # loopback by default: the demo is unauthenticated; pass --host 0.0.0.0
    # explicitly to expose it
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7860)  # gradio's default port
    ap.add_argument("--controller", default="http://localhost:21001")
    ap.add_argument("--caption-endpoint", default=None)
    ap.add_argument("--work-dir", default=None)
    args = ap.parse_args()
    srv = serve_web_demo(args.host, args.port, args.controller,
                         args.caption_endpoint, args.work_dir)
    print(f"web demo on http://{args.host}:{args.port}")
    srv.serve_forever()
