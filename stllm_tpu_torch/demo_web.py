"""Web chat demo on a stdlib HTTP server, no gradio needed (the root
demo_web.py of the JAX package).

A single-page app served by http.server: upload a video, ask questions in a
running conversation, with the reference demo's controls (beam count,
temperature, number of sampled segments).

Usage:
  python -m stllm_tpu_torch.demo_web --cfg-path config/tiny_debug.yaml --cpu  # random weights
  python -m stllm_tpu_torch.demo_web --serve-slots 4     # on the CUDA card, co-decoding
Then open http://localhost:7860/.

API (JSON): POST /api/upload (raw video bytes, X-Filename header) -> {session};
POST /api/ask {session, question, num_beams, temperature, max_new_tokens}
-> {answer}; POST /api/reset {session}.
"""

import argparse
import json
import tempfile
import threading
import uuid
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>ST-LLM demo</title><style>
body{font-family:system-ui,sans-serif;max-width:780px;margin:2rem auto;padding:0 1rem}
#log{border:1px solid #ccc;border-radius:8px;padding:1rem;min-height:200px;white-space:pre-wrap}
.h{color:#14532d}.a{color:#1e3a8a}.sys{color:#888}
input[type=range]{vertical-align:middle} label{margin-right:1.2rem;font-size:.9rem}
#q{width:70%} button{margin-left:.3rem}
</style></head><body>
<h2>ST-LLM — video chat</h2>
<p><input type="file" id="file" accept="video/*">
<button onclick="upload()">Upload video</button>
<button onclick="reset()">Restart</button></p>
<p>
<label>beams <input type="range" id="beams" min="1" max="10" value="1"
 oninput="bv.textContent=this.value"><span id="bv">1</span></label>
<label>temperature <input type="range" id="temp" min="0.1" max="2" step="0.1"
 value="1" oninput="tv.textContent=this.value"><span id="tv">1</span></label>
<label>segments <input type="range" id="segs" min="8" max="96" step="8"
 value="64" oninput="sv.textContent=this.value"><span id="sv">64</span></label>
</p>
<div id="log"><span class="sys">Upload a video to begin.</span></div>
<p><input id="q" placeholder="Ask about the video"
 onkeydown="if(event.key==='Enter')ask()"><button onclick="ask()">Send</button></p>
<script>
let session=null;
const log=(cls,txt)=>{const d=document.getElementById('log');
  d.innerHTML+=`\\n<span class="${cls}">${txt}</span>`;d.scrollTop=d.scrollHeight;};
async function upload(){
  const f=document.getElementById('file').files[0];
  if(!f){log('sys','choose a file first');return}
  log('sys','uploading + encoding…');
  const r=await fetch('/api/upload?segments='+document.getElementById('segs').value,
    {method:'POST',headers:{'X-Filename':f.name},body:f});
  const j=await r.json();
  if(j.error){log('sys','error: '+j.error);return}
  session=j.session;log('sys','video ready — ask away.');}
async function ask(){
  const q=document.getElementById('q').value.trim();
  if(!q||!session){log('sys',session?'type a question':'upload a video first');return}
  document.getElementById('q').value='';log('h','Human: '+q);
  const r=await fetch('/api/ask',{method:'POST',headers:{'Content-Type':'application/json'},
    body:JSON.stringify({session,question:q,
      num_beams:+document.getElementById('beams').value,
      temperature:+document.getElementById('temp').value})});
  const j=await r.json();
  log(j.error?'sys':'a',j.error?('error: '+j.error):('Assistant: '+j.answer));}
async function reset(){
  if(session)await fetch('/api/reset',{method:'POST',
    headers:{'Content-Type':'application/json'},body:JSON.stringify({session})});
  session=null;document.getElementById('log').innerHTML=
    '<span class="sys">Upload a video to begin.</span>';}
</script></body></html>"""


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Web demo (stdlib server)")
    parser.add_argument("--cfg-path",
                        default="config/instructblipbase_stllm_conversation.yaml")
    parser.add_argument("--ckpt-path", default=None)
    parser.add_argument("--options", nargs="+", default=None)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--serve-slots", type=int, default=0,
                        help="N>0 decodes concurrent sessions' answers "
                             "through an N-slot continuous batcher "
                             "(serving.AnswerService) instead of "
                             "serializing them; beam requests still take "
                             "the solo path")
    parser.add_argument("--serve-max-len", type=int, default=2048,
                        help="batcher KV budget per slot (prompt + answer)")
    parser.add_argument("--prefix-kv", type=int, default=0,
                        help="N>0 keeps the N most recently active "
                             "sessions' KV caches alive between turns "
                             "(generation.PrefixSession): each turn "
                             "prefills only its delta instead of the full "
                             "system+video+history prompt. A session's "
                             "bf16 Vicuna-7B cache at 2048 positions is "
                             "32 layers x (k, v) x 2048 x 4096 x 2 bytes = "
                             "1 GiB. Mutually exclusive with --serve-slots")
    return parser.parse_args(argv)


def build_chat(args):
    from stllm_tpu_torch.demo_core import build_chat as _build

    return _build(args.cfg_path, ckpt_path=args.ckpt_path, options=args.options,
                  device="cpu" if args.cpu else None)


class Session:
    def __init__(self):
        from stllm_tpu_torch.conversation import CONV_instructblip_Vicuna0

        self.conv = CONV_instructblip_Vicuna0.copy()
        self.img_list = []
        self.lock = threading.Lock()  # conv state is per-session serial


MAX_SESSIONS = 16  # each session holds full video embeddings on host


def make_handler(chat, service=None, prefix_kv=0):
    """``service`` (serving.AnswerService over a ContinuousBatcher) lets
    concurrent sessions co-decode through one shared batcher; without it,
    model calls serialize behind one lock.
    ``prefix_kv`` > 0 gives the N most recently asked sessions a persistent
    generation.PrefixSession, so later turns prefill only their delta —
    device KV memory is bounded by evicting (releasing) the least recently
    used session's cache."""
    if service is not None and prefix_kv > 0:
        raise ValueError("--serve-slots and --prefix-kv are mutually exclusive")
    # LRU-capped: uploads from abandoned tabs would otherwise accumulate
    # video embeddings forever (nothing expires them except /api/reset)
    sessions = OrderedDict()
    kv_lru = OrderedDict()  # sid -> PrefixSession, most recent last
    lock = threading.Lock()  # serializes encodes (and answers if no service)

    def _kv_for(sid):
        if prefix_kv <= 0:
            return None
        kv = kv_lru.pop(sid, None)
        if kv is None:
            from stllm_tpu_torch.models.generation import PrefixSession

            kv = PrefixSession(chat.params["llama"], chat.cfg.llama,
                               max_len=2048)
        kv_lru[sid] = kv
        while len(kv_lru) > prefix_kv:
            _, old = kv_lru.popitem(last=False)
            old.release()  # free device KV; that session re-prefills
        return kv

    class Handler(BaseHTTPRequestHandler):
        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.split("?")[0] != "/":
                return self._json({"error": "not found"}, 404)
            body = PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            try:
                path, _, query = self.path.partition("?")
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                if path == "/api/upload":
                    return self._upload(raw, query)
                if path == "/api/ask":
                    return self._ask(json.loads(raw))
                if path == "/api/reset":
                    sid = json.loads(raw).get("session")
                    sessions.pop(sid, None)
                    with lock:  # never release a cache mid-generate
                        kv = kv_lru.pop(sid, None)
                        if kv is not None:
                            kv.release()
                    return self._json({"ok": True})
                return self._json({"error": "not found"}, 404)
            except Exception as e:  # surface errors to the UI, keep serving
                return self._json({"error": f"{type(e).__name__}: {e}"}, 500)

        def _upload(self, raw, query):
            segments = 64
            for part in query.split("&"):
                if part.startswith("segments="):
                    segments = max(1, int(part.split("=", 1)[1]))
            name = self.headers.get("X-Filename", "video.mp4")
            suffix = "." + name.rsplit(".", 1)[-1] if "." in name else ".mp4"
            sess = Session()
            with tempfile.NamedTemporaryFile(suffix=suffix) as f:
                f.write(raw)
                f.flush()
                with lock:
                    chat.upload_video(f.name, sess.conv, sess.img_list,
                                      num_frame=segments)
            sid = uuid.uuid4().hex
            sessions[sid] = sess
            while len(sessions) > MAX_SESSIONS:
                sessions.popitem(last=False)  # evict least recently used
            return self._json({"session": sid})

        def _ask(self, req):
            sess = sessions.get(req.get("session"))
            if sess is None:
                return self._json({"error": "unknown session (re-upload)"}, 400)
            sessions.move_to_end(req["session"])  # mark recently used
            question = req["question"]
            num_beams = int(req.get("num_beams", 1))
            temperature = float(req.get("temperature", 1.0))
            # per-session lock: turns within one session stay ordered;
            # with a service, DIFFERENT sessions co-decode through the
            # shared batcher instead of queueing on the global lock
            outer = sess.lock if service is not None else lock
            with outer:
                chat.ask(question, sess.conv)
                answer, _ = chat.answer(
                    conv=sess.conv, img_list=sess.img_list,
                    num_beams=num_beams, temperature=temperature,
                    do_sample=temperature > 0 and num_beams == 1,
                    max_new_tokens=int(req.get("max_new_tokens", 300)),
                    max_length=2000, service=service,
                    # beam asks always take the solo path: don't let them
                    # create/LRU-bump a PrefixSession (evicting a live
                    # session's device KV for nothing)
                    kv_session=(None if num_beams > 1
                                else _kv_for(req["session"])),
                    seed=int(req.get("seed", 0)),
                )
            return self._json({"answer": answer})

        def log_message(self, fmt, *args):  # quiet access log
            pass

    return Handler


def main(argv=None):
    args = parse_args(argv)
    chat = build_chat(args)
    service = None
    if args.serve_slots > 0:
        from stllm_tpu_torch.serving import AnswerService, ContinuousBatcher

        service = AnswerService(ContinuousBatcher(
            chat.params["llama"], chat.cfg.llama, slots=args.serve_slots,
            max_len=args.serve_max_len))
    server = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(chat, service=service, prefix_kv=args.prefix_kv))
    print(f"ST-LLM web demo on http://{args.host}:{args.port}/")
    server.serve_forever()


if __name__ == "__main__":
    main()
