"""SBD packet extraction + ACARS parsing from reassembled IDA messages.

Host-side port of the reference `sbd_acars.c` fallback path (the
libacars-2 ARINC-622 path is an optional external dependency there too;
SURVEY §2.2 "fallback parser first"):
  - SBD marker heuristics (0x76/0x06):        sbd_acars.c:1056-1151
  - 8-slot multi-packet reassembly (5 s):     sbd_acars.c:381-399,1153-1216
  - ACARS fallback parse (0x01 marker, CRC-16/Kermit, parity strip,
    field extraction):                        sbd_acars.c:603-996
  - text / dumpvdl2-style JSON / UDP / acarshub feed outputs
  - stats:                                    sbd_acars.c:1336-1349
"""

from __future__ import annotations

import dataclasses
import json
import socket
import sys
import time

SBD_MAX_MULTI = 8
SBD_MAX_DATA = 1024
SBD_TIMEOUT_NS = 5_000_000_000


def crc16_kermit(data: bytes) -> int:
    """Reflected CRC-16, poly 0x8408, init 0 (sbd_acars.c:359-377)."""
    crc = 0
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ 0x8408 if crc & 1 else crc >> 1
    return crc


@dataclasses.dataclass
class _Multi:
    active: bool = False
    msgno: int = 0
    msgcnt: int = 0
    ul: bool = False
    timestamp: int = 0
    frequency: float = 0.0
    magnitude: float = 0.0
    data: bytes = b""


@dataclasses.dataclass
class AcarsMessage:
    """Parsed fallback-ACARS fields (pre-ARINC-622)."""
    mode: str
    reg: str                 # with leading dots preserved
    ack: str
    label: str
    blk_id: str
    cont: bool
    flight: str
    msg_num: str
    msg_num_seq: str
    text: str
    errors: int
    ul: bool
    timestamp_ns: int
    frequency: float
    magnitude: float
    header: bytes


class AcarsDecoder:
    def __init__(self, json_out: bool = False, udp_targets=(),
                 station: str | None = None, text_out=None,
                 feed_sender=None, wall_t0: float | None = None,
                 la="auto"):
        # Primary ACARS decoder is libacars-2 when present (ARINC-622
        # ADS-C/CPDLC, multi-block reassembly; sbd_acars.c:410-601); the
        # manual parser below is the fallback (:603-996). `la` accepts a
        # LibAcars-like object for tests, None to force the fallback.
        if la == "auto":
            from . import libacars
            la = libacars.load()
        self.la = la
        self.json_out = json_out
        self.station = station
        self.text_out = text_out or sys.stdout
        self.feed_sender = feed_sender      # callable(json_str) or None
        self.multi = [_Multi() for _ in range(SBD_MAX_MULTI)]
        self.stats = dict(ida_total=0, sbd_total=0, sbd_short=0,
                          sbd_single=0, sbd_multi_ok=0, sbd_multi_frag=0,
                          sbd_broken=0, acars_total=0, acars_errors=0)
        self._udp = []
        for t in udp_targets:
            host, _, port = t.partition(":")
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._udp.append((s, (host, int(port))))
        self._wall_t0 = wall_t0
        self._first_ts = None
        self.messages: list[AcarsMessage] = []   # retained for callers

    # ---- timestamps (sbd_acars.c:322-356) ----

    def _unix(self, ts_ns: int) -> float:
        if self._first_ts is None:
            self._first_ts = ts_ns
            if self._wall_t0 is None:
                self._wall_t0 = time.time()
        return self._wall_t0 + (ts_ns - self._first_ts) / 1e9

    def _iso(self, ts_ns: int) -> str:
        return time.strftime("%Y-%m-%dT%H:%M:%SZ",
                             time.gmtime(self._unix(ts_ns)))

    # ---- entry point: reassembled IDA message ----

    def process(self, data: bytes, timestamp_ns: int, frequency: float,
                direction: str, magnitude: float) -> None:
        self.stats["ida_total"] += 1
        self._sbd_extract(bytes(data), direction == "UL", timestamp_ns,
                          frequency, magnitude)

    # ---- SBD extraction (sbd_acars.c:1059-1216) ----

    def _sbd_extract(self, data: bytes, ul: bool, ts: int, freq: float,
                     mag: float) -> None:
        if len(data) < 5:
            return
        is_sbd = False
        if data[0] == 0x76 and data[1] != 5:
            if ul:
                is_sbd = 0x0C <= data[1] <= 0x0E
            else:
                is_sbd = 0x08 <= data[1] <= 0x0B
        elif data[0] == 0x06 and data[1] == 0x00:
            is_sbd = data[2] in (0x00, 0x10, 0x20, 0x40, 0x50, 0x70)
        if not is_sbd:
            return
        self.stats["sbd_total"] += 1

        typ0, typ1 = data[0], data[1]
        body = data[2:]

        if typ0 == 0x06 and typ1 == 0x00:
            if len(body) < 30 or body[0] != 0x20:
                return
            msgcnt = body[15]
            msgno = 0 if msgcnt == 0 else 1
            sbd = body[29:]
        else:
            if typ1 == 0x08:
                if len(body) < 5:
                    return
                prehdr = 5 if body[0] == 0x20 else 7
                if len(body) < prehdr:
                    return
                msgcnt = body[3]
                body = body[prehdr:]
            else:
                msgcnt = -1
            if ul and len(body) >= 3 and body[0] in (0x50, 0x51):
                body = body[3:]
            if len(body) == 0:
                msgno = 0
                sbd = b""
            elif len(body) > 3 and body[0] == 0x10:
                pkt_len = body[1]
                msgno = body[2]
                body = body[3:]
                if len(body) < pkt_len:
                    return
                sbd = body[:pkt_len]
            else:
                msgno = 0
                sbd = body

        self._expire(ts)

        if msgno == 0:
            self.stats["sbd_short"] += 1
            if sbd:
                self._sbd_process(sbd, ul, ts, freq, mag)
        elif msgcnt == 1 and msgno == 1:
            self.stats["sbd_single"] += 1
            self._sbd_process(sbd, ul, ts, freq, mag)
        elif msgcnt > 1:
            slot = next((s for s in self.multi if not s.active), None)
            if slot is None:
                slot = min(self.multi, key=lambda s: s.timestamp)
            slot.active = True
            slot.msgno = msgno
            slot.msgcnt = msgcnt
            slot.ul = ul
            slot.timestamp = ts
            slot.frequency = freq
            slot.magnitude = mag
            slot.data = sbd[:SBD_MAX_DATA]
        elif msgno > 1:
            for s in reversed(self.multi):
                if not s.active or s.ul != ul or msgno != s.msgno + 1:
                    continue
                space = SBD_MAX_DATA - len(s.data)
                s.data += sbd[:max(space, 0)]
                s.msgno = msgno
                s.timestamp = ts
                self.stats["sbd_multi_frag"] += 1
                if msgno == s.msgcnt:
                    self.stats["sbd_multi_ok"] += 1
                    self._sbd_process(s.data, ul, ts, s.frequency,
                                      s.magnitude)
                    s.active = False
                return
            self.stats["sbd_broken"] += 1

    def _expire(self, now_ns: int) -> None:
        for s in self.multi:
            if s.active and now_ns > s.timestamp + SBD_TIMEOUT_NS:
                s.active = False

    # ---- SBD dispatch ----

    def _sbd_process(self, sbd: bytes, ul: bool, ts: int, freq: float,
                     mag: float) -> None:
        if len(sbd) > 2 and sbd[0] == 0x01:
            if self.la is not None:
                self._acars_parse_libacars(sbd, ul, ts, freq, mag)
            else:
                self._acars_parse(sbd, ul, ts, freq, mag)
            return
        if sbd:
            self._sbd_raw(sbd, ul, ts)

    # ---- primary ACARS parse via libacars (sbd_acars.c:463-601) ----

    def _acars_parse_libacars(self, data: bytes, ul: bool, ts: int,
                              freq: float, mag: float) -> None:
        data = data[1:]                         # strip SOH
        hdr = b""
        if data and data[0] == 0x03 and len(data) >= 8:
            hdr = data[:8]                      # iridium-specific header
            data = data[8:]
        if len(data) < 13:
            return
        parsed = self.la.parse(bytes(data), ul, self._unix(ts))
        if parsed is None:
            return
        if parsed.reasm_in_progress:
            return
        self.stats["acars_total"] += 1
        if parsed.err:
            self.stats["acars_errors"] += 1

        if self.json_out or self._udp:
            if not parsed.err:
                js = self._la_envelope(parsed, ts, freq, mag, hdr)
                if self.json_out:
                    print(js, file=self.text_out)
                for s, addr in self._udp:
                    try:
                        s.sendto(js.encode(), addr)
                    except OSError:
                        pass
        if not self.json_out:
            line = (f"ACARS: {self._iso(ts)} {'UL' if ul else 'DL'} "
                    + ("[hdr:iridium] " if hdr else ""))
            print(line + "\n" + parsed.text, file=self.text_out, end="")

        if self.feed_sender is not None and not parsed.err:
            a = parsed.acars
            m = AcarsMessage(
                mode=a.get("mode", ""), reg=a.get("reg", ""),
                ack=a.get("ack", ""), label=a.get("label", ""),
                blk_id=a.get("blk_id", ""),
                cont=bool(a.get("more", False)),
                flight=a.get("flight", ""), msg_num=a.get("msg_num", ""),
                msg_num_seq=a.get("msg_num_seq", ""),
                text=a.get("msg_text", ""),
                errors=0, ul=ul, timestamp_ns=ts, frequency=freq,
                magnitude=mag, header=hdr)
            self.feed_sender(self._to_feed_json(m))
        self.messages.append(parsed)

    def _la_envelope(self, parsed, ts: int, freq: float, mag: float,
                     hdr: bytes) -> str:
        """dumpvdl2-style "iridium" JSON envelope wrapping the full
        libacars tree (sbd_acars.c:427-459,524-548)."""
        unix = self._unix(ts)
        body = {
            "iridium": {
                "app": {"name": "iridium-tpu", "ver": "0.1"},
                **({"station": self.station} if self.station else {}),
                "t": {"sec": int(unix),
                      "usec": int((unix - int(unix)) * 1e6)},
                "freq": int(freq),
                "sig_level": round(mag, 2),
                **({"header": hdr.hex()} if hdr else {}),
                **parsed.tree,
            }
        }
        return json.dumps(body, separators=(",", ":"))

    def _sbd_raw(self, sbd: bytes, ul: bool, ts: int) -> None:
        hexs = sbd[:64].hex()
        if len(sbd) > 64:
            hexs += "..."
        txt = "".join(chr(c) if 0x20 <= c < 0x7F else "." for c in sbd[:64])
        print(f"SBD: {self._iso(ts)} {'UL' if ul else 'DL'} {hexs} | {txt}",
              file=self.text_out)

    # ---- fallback ACARS parse (sbd_acars.c:862-996) ----

    def _acars_parse(self, data: bytes, ul: bool, ts: int, freq: float,
                     mag: float) -> None:
        if not data or data[0] != 0x01 or len(data) <= 2:
            return
        data = data[1:]

        has_crc = False
        csum = b"\x00\x00"
        if len(data) >= 3 and data[-1] == 0x7F:
            csum = data[-3:-1]
            data = data[:-3]
            has_crc = True

        hdr = b""
        if data and data[0] == 0x03 and len(data) >= 8:
            hdr = data[:8]
            data = data[8:]

        crc_errors = 0 if (has_crc
                           and crc16_kermit(data + csum) == 0) else 1
        if len(data) < 13:
            return

        parity_ok = True
        stripped = bytearray()
        for c in data:
            if bin(c).count("1") % 2 == 0:
                parity_ok = False
            stripped.append(c & 0x7F)
        stripped = bytes(stripped)
        errors = crc_errors + (0 if parity_ok else 1)

        self.stats["acars_total"] += 1
        if errors:
            self.stats["acars_errors"] += 1

        msg = self._extract_fields(stripped, ul, errors, ts, freq, mag, hdr)
        self.messages.append(msg)

        if (self.json_out or self._udp) and errors > 0:
            return
        if self.json_out or self._udp:
            js = self._to_json(msg)
            if self.json_out:
                print(js, file=self.text_out)
            for s, addr in self._udp:
                s.sendto(js.encode(), addr)
        if not self.json_out:
            self._print_text(msg)
        if self.feed_sender is not None and errors == 0:
            self.feed_sender(self._to_feed_json(msg))

    def _extract_fields(self, d: bytes, ul: bool, errors: int, ts: int,
                        freq: float, mag: float, hdr: bytes) -> AcarsMessage:
        mode = chr(d[0])
        reg = d[1:8].decode("latin1")
        ack = chr(d[8])
        label = chr(d[9]) + ("d" if d[9] == ord("_") and d[10] == 0x7F
                             else chr(d[10]))
        blk_id = chr(d[11])
        rest = d[12:]
        cont = False
        if rest:
            if rest[-1] == 0x03:
                rest = rest[:-1]
            elif rest[-1] == 0x17:
                cont = True
                rest = rest[:-1]
        flight = msg_num = ""
        msg_num_seq = ""
        text = ""
        if rest and rest[0] == 0x02:
            if ul and len(rest) >= 11:
                msg_num = rest[1:4].decode("latin1")
                msg_num_seq = chr(rest[4])
                flight = rest[5:11].decode("latin1")
                text = rest[11:].decode("latin1")
            else:
                text = rest[1:].decode("latin1")
        return AcarsMessage(mode=mode, reg=reg, ack=ack, label=label,
                            blk_id=blk_id, cont=cont, flight=flight,
                            msg_num=msg_num, msg_num_seq=msg_num_seq,
                            text=text, errors=errors, ul=ul,
                            timestamp_ns=ts, frequency=freq,
                            magnitude=mag, header=hdr)

    def _to_json(self, m: AcarsMessage) -> str:
        """dumpvdl2-style "iridium" envelope (sbd_acars.c:648-766)."""
        unix = self._unix(m.timestamp_ns)
        body: dict = {
            "iridium": {
                "app": {"name": "iridium-tpu", "ver": "0.1"},
                **({"station": self.station} if self.station else {}),
                "t": {"sec": int(unix),
                      "usec": int((unix - int(unix)) * 1e6)},
                "freq": int(m.frequency),
                "sig_level": round(m.magnitude, 2),
                **({"header": m.header.hex()} if m.header else {}),
                "acars": {
                    "err": False, "crc_ok": True, "more": m.cont,
                    "reg": m.reg, "mode": m.mode, "label": m.label,
                    "blk_id": m.blk_id, "ack": m.ack,
                    **({"flight": m.flight, "msg_num": m.msg_num,
                        "msg_num_seq": m.msg_num_seq}
                       if m.ul and m.flight else {}),
                    **({"msg_text": m.text} if m.text else {}),
                },
            }
        }
        return json.dumps(body, separators=(",", ":"))

    def _to_feed_json(self, m: AcarsMessage) -> str:
        """acarshub/airframes feed (iridium-toolkit format,
        sbd_acars.c:226-303)."""
        reg = m.reg.lstrip(".")
        body = {
            "app": {"name": "iridium-toolkit", "version": "0.0.1"},
            "source": {"transport": "iridium", "protocol": "acars",
                       **({"station_id": self.station}
                          if self.station else {})},
            "acars": {
                "timestamp": self._iso(m.timestamp_ns),
                "errors": m.errors,
                "link_direction": "uplink" if m.ul else "downlink",
                "block_end": not m.cont,
                "mode": m.mode, "tail": reg, "label": m.label,
                "block_id": m.blk_id,
                "ack": "!" if m.ack == "\x15" else m.ack,
                **({"flight": m.flight} if m.flight else {}),
                **({"message_number": m.msg_num} if m.msg_num else {}),
                "text": m.text,
            },
            "freq": round(m.frequency, 1),
            "level": round(m.magnitude, 2),
            "header": m.header.hex(),
        }
        return json.dumps(body, separators=(",", ":"))

    def _print_text(self, m: AcarsMessage) -> None:
        reg = m.reg.lstrip(".")
        ack = "NAK " if m.ack == "\x15" else f"ACK:{m.ack}"
        label = m.label if not (m.label.startswith("_")
                                and m.label[1] == "\x7f") else "_?"
        line = (f"ACARS: {self._iso(m.timestamp_ns)} "
                f"{'UL' if m.ul else 'DL'} Mode:{m.mode} REG:{reg:<7} "
                f"{ack} Label:{label} bID:{m.blk_id} ")
        if m.ul and m.flight:
            line += f"SEQ:{m.msg_num}{m.msg_num_seq} FNO:{m.flight} "
        if m.text:
            printable = "".join(c if 0x20 <= ord(c) < 0x7F else "."
                                for c in m.text)
            line += f"[{printable}]"
        if m.cont:
            line += " CONT'd"
        if m.errors:
            line += " ERRORS"
        print(line, file=self.text_out)

    def print_stats(self) -> None:
        s = self.stats
        print(f"sbd: {s['sbd_total']} packets ({s['sbd_short']} short, "
              f"{s['sbd_single']} single, {s['sbd_multi_ok']} multi); "
              f"acars: {s['acars_total']} decoded, "
              f"{s['acars_errors']} with errors", file=sys.stderr)


class FeedSender:
    """UDP or TCP JSON feed (udp://host:port for acarshub,
    tcp://host:port for airframes.io with per-message reconnect,
    sbd_acars.c:160-192)."""

    def __init__(self, url: str = "tcp://feed.airframes.io:5590"):
        proto, _, rest = url.partition("://")
        host, _, port = rest.partition(":")
        self.proto = proto
        self.addr = (host, int(port))
        self._udp = (socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                     if proto == "udp" else None)

    def __call__(self, js: str) -> None:
        data = js.encode() + b"\n"
        if self.proto == "udp":
            self._udp.sendto(data, self.addr)
        else:
            try:
                with socket.create_connection(self.addr, timeout=5) as s:
                    s.sendall(data)
            except OSError:
                pass
