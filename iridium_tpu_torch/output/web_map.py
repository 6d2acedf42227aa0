"""Live web map: HTTP + SSE server with satellite/beam/MT state.

Host-side port of the reference `web_map.c`:
  - state rings + dedup/routing:  web_map.c:128-278 (ground beams at
    alt<100 km with 20-entry dedup, orbital RA at 700-900 km, sat table)
  - MT position extraction from IDA messages (0x0605/0x7605/0x0600,
    12-bit XYZ in 5 bytes):       web_map.c:280-361
  - JSON snapshot schema:         web_map.c:365-467
  - endpoints `/`, `/api/state`, `/api/events` (1 Hz SSE):
                                  web_map.c:747-892

The Leaflet page is an original implementation (same data contract).
"""

from __future__ import annotations

import http.server
import json
import math
import threading
import time

MAX_RA_POINTS = 2000
MAX_BEAM_POINTS = 2000
MAX_MT_POINTS = 500
MAX_SATELLITES = 100

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>iridium-tpu live map</title>
<link rel="stylesheet" href="https://unpkg.com/leaflet@1.9.4/dist/leaflet.css"/>
<script src="https://unpkg.com/leaflet@1.9.4/dist/leaflet.js"></script>
<style>
 html,body,#map{height:100%;margin:0;background:#111}
 #hud{position:absolute;top:8px;right:8px;z-index:1000;background:#000c;
      color:#8f8;font:12px monospace;padding:8px 10px;border-radius:6px}
</style></head><body>
<div id="map"></div><div id="hud">waiting for data…</div>
<script>
const map = L.map('map').setView([30,0],2);
L.tileLayer('https://{s}.basemaps.cartocdn.com/dark_all/{z}/{x}/{y}.png',
  {maxZoom:10, attribution:'&copy; OSM &copy; CARTO'}).addTo(map);
const raLayer = L.layerGroup().addTo(map);
const beamLayer = L.layerGroup().addTo(map);
const mtLayer = L.layerGroup().addTo(map);
const rxLayer = L.layerGroup().addTo(map);
function render(d){
  document.getElementById('hud').textContent =
    `IRA ${d.total_ira}  IBC ${d.total_ibc}  pages ${d.total_pages}  ` +
    `beams ${d.total_beams}  MT ${d.total_mt}  sats ${d.sats.length}`;
  raLayer.clearLayers(); beamLayer.clearLayers(); mtLayer.clearLayers();
  rxLayer.clearLayers();
  for (const p of d.ra) L.circleMarker([p.lat,p.lon],
     {radius:3,color:'#4af',weight:1}).bindTooltip(
     `sat ${p.sat} beam ${p.beam} alt ${p.alt}km`).addTo(raLayer);
  for (const p of d.beams) L.circleMarker([p.lat,p.lon],
     {radius:4,color:'#fa4',weight:1}).bindTooltip(
     `beam ${p.beam} sat ${p.sat} pages ${p.pages}`).addTo(beamLayer);
  for (const p of d.mt) L.circleMarker([p.lat,p.lon],
     {radius:5,color:'#f4a',weight:2}).bindTooltip(
     `MT type 0x${p.type.toString(16)}`).addTo(mtLayer);
  if (d.rx) L.marker([d.rx.lat,d.rx.lon]).bindTooltip(
     `receiver (HDOP ${d.rx.hdop})`).addTo(rxLayer);
}
const es = new EventSource('/api/events');
es.onmessage = (e) => render(JSON.parse(e.data));
fetch('/api/state').then(r=>r.json()).then(render);
</script></body></html>"""


def mtpos_xyz(data: bytes, skip: int):
    """12-bit signed XYZ packed in 5 bytes (web_map.c:283-320)."""
    val = 0
    for i in range(5):
        val = (val << 8) | data[i]
    sb = 4 - skip
    x = (val >> (24 + sb)) & 0xFFF
    y = (val >> (12 + sb)) & 0xFFF
    z = (val >> sb) & 0xFFF
    if x > 0x7FF:
        x -= 0x1000
    if y > 0x7FF:
        y -= 0x1000
    if z > 0x7FF:
        z -= 0x1000
    if x == 0 and y == 0 and z == 0:
        return None
    xy = math.sqrt(x * x + y * y)
    lat = math.degrees(math.atan2(z, xy))
    lon = math.degrees(math.atan2(y, x))
    radius_km = math.sqrt(x * x + y * y + z * z) * 4.0
    alt = int(radius_km - 6371.0)
    if not (-90 <= lat <= 90):
        return None
    if radius_km < 5000.0 or radius_km > 7000.0:
        return None
    return lat, lon, alt


def extract_mt_position(data: bytes, direction: str):
    """MT position candidates in IDA messages (web_map.c:323-361)."""
    if len(data) < 5:
        return None
    msg_type = (data[0] << 8) | data[1]
    if msg_type == 0x0605:
        if len(data) >= 42 and data[36] == 0x1B:
            r = mtpos_xyz(data[37:42], 0)
            if r:
                return (msg_type,) + r
    elif msg_type == 0x7605:
        if len(data) >= 8 and data[2] == 0x00 and (data[3] & 0xF0) == 0x40:
            r = mtpos_xyz(data[3:8], 4)
            if r:
                return (msg_type,) + r
    elif msg_type == 0x0600:
        if (direction == "UL" and len(data) >= 24
                and data[2] in (0x10, 0x40, 0x70) and data[18] == 0x01):
            r = mtpos_xyz(data[19:24], 0)
            if r:
                return (msg_type,) + r
    return None


class WebMap:
    def __init__(self, port: int = 8888, host: str = "0.0.0.0"):
        self.port = port
        self.host = host
        self.lock = threading.Lock()
        self.ra: list[dict] = []
        self.beams: list[dict] = []
        self.mt: list[dict] = []
        self.sats: dict[int, dict] = {}
        self.totals = dict(ira=0, ibc=0, pages=0, beams=0, mt=0)
        self.rx = None
        self._httpd = None
        self._thread = None

    # ---- state writers ----

    def add_ra(self, ira, timestamp_ns: int, frequency: float) -> None:
        if not (-90 <= ira.lat <= 90) or not (-180 <= ira.lon <= 180):
            return
        if (ira.sat_id == 0 and ira.beam_id == 0 and ira.lat == 0
                and ira.lon == 0):
            return
        entry = dict(lat=ira.lat, lon=ira.lon, alt=ira.alt,
                     sat=ira.sat_id, beam=ira.beam_id,
                     pages=len(ira.pages),
                     tmsi=ira.pages[0][0] if ira.pages else 0,
                     freq=frequency, t=timestamp_ns // 1_000_000_000)
        with self.lock:
            if 0 <= ira.alt < 100:
                self.totals["ira"] += 1
                # dedup against the 20 most recent beams
                for b in self.beams[-20:]:
                    if (b["sat"] == ira.sat_id
                            and abs(b["lat"] - ira.lat) < 0.001
                            and abs(b["lon"] - ira.lon) < 0.001):
                        b["t"] = entry["t"]
                        if ira.pages:
                            b["pages"] = len(ira.pages)
                            b["tmsi"] = ira.pages[0][0]
                            self.totals["pages"] += 1
                        self.totals["beams"] += 1
                        return
                self.beams.append(entry)
                if len(self.beams) > MAX_BEAM_POINTS:
                    self.beams.pop(0)
                self.totals["beams"] += 1
                if ira.pages:
                    self.totals["pages"] += 1
                return
            if ira.alt < 700 or ira.alt > 900:
                return
            self.ra.append(entry)
            if len(self.ra) > MAX_RA_POINTS:
                self.ra.pop(0)
            self.totals["ira"] += 1
            if ira.pages:
                self.totals["pages"] += 1

    def add_sat(self, ibc, timestamp_ns: int) -> None:
        if ibc.sat_id == 0:
            return
        with self.lock:
            s = self.sats.get(ibc.sat_id)
            if s is None:
                if len(self.sats) >= MAX_SATELLITES:
                    return
                s = dict(id=ibc.sat_id, beam=0, count=0, last_seen=0)
                self.sats[ibc.sat_id] = s
            s["beam"] = ibc.beam_id
            s["last_seen"] = timestamp_ns
            s["count"] += 1
            self.totals["ibc"] += 1

    def add_mt(self, lat, lon, alt, msg_type, timestamp_ns, frequency):
        if not (-90 <= lat <= 90) or not (-180 <= lon <= 180):
            return
        with self.lock:
            self.mt.append(dict(lat=lat, lon=lon, alt=alt, type=msg_type,
                                freq=frequency,
                                t=timestamp_ns // 1_000_000_000))
            if len(self.mt) > MAX_MT_POINTS:
                self.mt.pop(0)
            self.totals["mt"] += 1

    def mtpos_ida_cb(self, data, timestamp_ns, frequency, direction,
                     magnitude) -> None:
        r = extract_mt_position(bytes(data), direction)
        if r:
            msg_type, lat, lon, alt = r
            self.add_mt(lat, lon, alt, msg_type, timestamp_ns, frequency)

    def set_position(self, lat, lon, hdop) -> None:
        with self.lock:
            self.rx = dict(lat=round(lat, 6), lon=round(lon, 6),
                           hdop=round(hdop, 1))

    # ---- JSON snapshot (schema of web_map.c:365-467) ----

    def snapshot(self) -> dict:
        with self.lock:
            max_ts = max((s["last_seen"] for s in self.sats.values()),
                         default=0)
            window = 15 * 60 * 1_000_000_000
            sats = [dict(id=s["id"], beam=s["beam"], count=s["count"])
                    for s in self.sats.values()
                    if not (max_ts > window
                            and s["last_seen"] < max_ts - window)]
            out = dict(
                total_ira=self.totals["ira"],
                total_ibc=self.totals["ibc"],
                total_pages=self.totals["pages"],
                total_beams=self.totals["beams"],
                total_mt=self.totals["mt"],
                ra=list(reversed(self.ra[-500:])),
                beams=list(reversed(self.beams[-300:])),
                mt=list(reversed(self.mt[-200:])),
                sats=sats,
            )
            if self.rx:
                out["rx"] = dict(self.rx)
            return out

    # ---- HTTP server ----

    def start(self) -> None:
        web_map = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/api/state":
                    body = json.dumps(web_map.snapshot()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Access-Control-Allow-Origin", "*")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/api/events":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    try:
                        while web_map._httpd is not None:
                            body = json.dumps(web_map.snapshot())
                            self.wfile.write(
                                f"data: {body}\n\n".encode())
                            self.wfile.flush()
                            time.sleep(1.0)
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_error(404)

        self._httpd = http.server.ThreadingHTTPServer(
            (self.host, self.port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._httpd is not None:
            httpd = self._httpd
            self._httpd = None
            httpd.shutdown()
            httpd.server_close()
