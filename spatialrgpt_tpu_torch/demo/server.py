"""Demo servers: Gradio UI (when installed) or stdlib HTTP JSON API.

The UI surface of the reference's demo/gradio_web_server_multi.py; all
logic lives in demo/engine.py.

The port's own copy of ``spatialrgpt_tpu/demo/server.py``.
"""

from __future__ import annotations

import base64
import io
import json
from typing import Optional

import numpy as np

from spatialrgpt_tpu_torch.demo.engine import DemoEngine, DemoState


def launch_gradio(engine: DemoEngine, **launch_kwargs):  # pragma: no cover
    import gradio as gr

    state = DemoState()

    def on_image(img):
        engine.set_image(state, np.asarray(img))
        return "image loaded; draw boxes then chat"

    def on_boxes(box_text):
        boxes = json.loads(box_text)
        overlay = engine.add_regions(state, boxes)
        return overlay

    def on_chat(msg, history):
        return engine.chat(state, msg)

    with gr.Blocks(title="SpatialRGPT-TPU") as ui:
        img = gr.Image(label="image")
        status = gr.Textbox(label="status")
        img.change(on_image, inputs=img, outputs=status)
        boxes = gr.Textbox(label="boxes json [[x1,y1,x2,y2],...]")
        overlay = gr.Image(label="regions")
        boxes.submit(on_boxes, inputs=boxes, outputs=overlay)
        chat = gr.ChatInterface(on_chat)
    ui.launch(**launch_kwargs)


class HTTPDemoServer:  # pragma: no cover - thin stdlib wrapper
    """POST /image {b64 png}, POST /regions {boxes}, POST /chat {text}."""

    def __init__(self, engine: DemoEngine, port: int = 7860):
        self.engine = engine
        self.port = port
        self.state = DemoState()

    def serve(self):
        from http.server import BaseHTTPRequestHandler, HTTPServer
        from PIL import Image

        engine, state = self.engine, self.state

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/image":
                    raw = base64.b64decode(payload["image_b64"])
                    img = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
                    engine.set_image(state, img)
                    out = {"status": "ok"}
                elif self.path == "/regions":
                    overlay = engine.add_regions(state, payload["boxes"])
                    buf = io.BytesIO()
                    Image.fromarray(overlay).save(buf, "PNG")
                    out = {"overlay_b64": base64.b64encode(buf.getvalue()).decode()}
                elif self.path == "/chat":
                    out = {"response": engine.chat(state, payload["text"])}
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                body = json.dumps(out).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        HTTPServer(("0.0.0.0", self.port), Handler).serve_forever()
