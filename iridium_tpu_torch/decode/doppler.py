"""Doppler-based receiver geolocation from IRA satellite broadcasts.

Host-side numpy port of the reference `doppler_pos.c` (per SURVEY §2.2 the
data rate here is a few frames/s — host math, not device):
  - per-sat circular buffers + sanity gates:   doppler_pos.c:341-417
  - channel-frequency voting (41.667 kHz):     doppler_pos.c:160-198
  - orbital velocity (h = r1 x r2, vis-viva):  doppler_pos.c:211-274
  - motion-validated spatial clustering:       doppler_pos.c:444-570
  - iterated WLS ([x,y,z,clk-drift], Earth-
    rotation terms, LM damping, step clamp):   doppler_pos.c:707-845
  - height aiding (w=100):                     doppler_pos.c:765-789
  - 3-sigma outlier rejection + re-solve:      doppler_pos.c:864-1014
  - per-sat residual screen (3x median):       doppler_pos.c:1016-1212
  - HDOP via ENU-rotated covariance:           doppler_pos.c:1214-1279
  - 500 km jump guard:                         doppler_pos.c:1285-1322
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import wgs84
from ..output.gsmtap import IR_BASE_FREQ, IR_CHANNEL_WIDTH

MAX_SATELLITES = 128
MEAS_PER_SAT = 200
MIN_MEASUREMENTS = 8
MIN_SATELLITES = 2
MAX_ITERATIONS = 200
CONVERGENCE_M = 100.0
OUTLIER_SIGMA = 3.0
MAX_MEAS_AGE_NS = 30 * 60 * 1_000_000_000
MIN_VEL_INTERVAL_S = 2.0
MAX_SAT_CLUSTER_DIST = 8000e3
SAT_GAP_RESET_S = 600.0
MAX_SOLUTION_JUMP = 500e3


@dataclasses.dataclass
class Solution:
    lat: float = 0.0
    lon: float = 0.0
    alt: float = 0.0
    hdop: float = 99.9
    n_measurements: int = 0
    n_satellites: int = 0
    converged: bool = False


class _SatBuffer:
    def __init__(self, sat_id):
        self.sat_id = sat_id
        self.ecef: list[np.ndarray] = []
        self.freq: list[float] = []
        self.ts: list[int] = []

    def add(self, ecef, freq, ts):
        self.ecef.append(np.asarray(ecef, float))
        self.freq.append(float(freq))
        self.ts.append(int(ts))
        if len(self.ts) > MEAS_PER_SAT:
            self.ecef.pop(0)
            self.freq.pop(0)
            self.ts.pop(0)

    @property
    def count(self):
        return len(self.ts)

    def reset(self):
        self.ecef.clear()
        self.freq.clear()
        self.ts.clear()


def assign_channel_freq(freq: float) -> float:
    chan = round((freq - IR_BASE_FREQ) / IR_CHANNEL_WIDTH)
    return IR_BASE_FREQ + chan * IR_CHANNEL_WIDTH


class DopplerSolver:
    def __init__(self, height_aid_m: float | None = None):
        self.sats: dict[int, _SatBuffer] = {}
        self.height_aid = height_aid_m
        self.prev_ecef = None
        self.prev_clock_drift = 0.0
        self.jump_reject_count = 0

    # ---- measurement ingest ----

    def add_measurement(self, ira, frequency: float, timestamp_ns: int):
        """ira: decode.frame.IraData (needs sat_id, lat, lon, pos_xyz)."""
        if ira.sat_id == 0:
            return
        if not (-90 <= ira.lat <= 90) or not (-180 <= ira.lon <= 180):
            return
        ecef = np.asarray(ira.pos_xyz, float) * 4000.0
        r = np.linalg.norm(ecef)
        if r < 7050e3 or r > 7250e3:
            return
        s = self.sats.get(ira.sat_id)
        if s is None:
            if len(self.sats) >= MAX_SATELLITES:
                return
            s = _SatBuffer(ira.sat_id)
            self.sats[ira.sat_id] = s
        if s.count > 0:
            dt = (timestamp_ns - s.ts[-1]) / 1e9
            if dt > SAT_GAP_RESET_S:
                s.reset()
            else:
                dist = np.linalg.norm(ecef - s.ecef[-1])
                if 0 < dt < 120 and dist / dt > 10000.0:
                    return
        s.add(ecef, frequency, timestamp_ns)

    # ---- velocity estimation ----

    def _estimate_velocity(self, s: _SatBuffer, idx: int):
        cur_e = s.ecef[idx]
        cur_t = s.ts[idx]
        r_norm = np.linalg.norm(cur_e)
        if r_norm < 1e6:
            return None
        best_dt = 0.0
        best = None
        for i in range(s.count):
            if i == idx:
                continue
            dt = abs((s.ts[i] - cur_t) / 1e9)
            if dt >= MIN_VEL_INTERVAL_S and dt < 600.0 and dt > best_dt:
                other_r = np.linalg.norm(s.ecef[i])
                if other_r < 7050e3 or other_r > 7250e3:
                    continue
                best_dt = dt
                best = i
        if best is None:
            return None
        h = np.cross(cur_e, s.ecef[best])
        if np.linalg.norm(h) < 1e6:
            return None
        v_dir = np.cross(h, cur_e)
        v_norm = np.linalg.norm(v_dir)
        if v_norm < 1.0:
            return None
        if s.ts[best] > cur_t:
            forward = s.ecef[best] - cur_e
        else:
            forward = cur_e - s.ecef[best]
        sign = 1.0 if np.dot(v_dir, forward) >= 0 else -1.0
        speed = np.sqrt(wgs84.GM_EARTH / r_norm)
        return sign * speed * v_dir / v_norm

    def _channel_freq(self, s: _SatBuffer, now: int) -> float:
        chans = [assign_channel_freq(f)
                 for f, t in zip(s.freq, s.ts)
                 if not (now > 0 and now - t > MAX_MEAS_AGE_NS)]
        if not chans:
            return 0.0
        best_f, best_c = 0.0, 0
        for c in chans:
            cnt = sum(1 for o in chans if abs(o - c) < 1.0)
            if cnt > best_c:
                best_c, best_f = cnt, c
        return best_f

    # ---- WLS core ----

    def _wls(self, rx, clk, sat_e, sat_v, rr, w, use_height):
        """One iterated-WLS run; returns (rx, clk, converged)."""
        rx = rx.copy()
        for it in range(MAX_ITERATIONS):
            rx_vel = np.array([-wgs84.OMEGA_EARTH * rx[1],
                               wgs84.OMEGA_EARTH * rx[0], 0.0])
            los = sat_e - rx
            rho = np.linalg.norm(los, axis=1)
            ok = rho >= 1.0
            rel = sat_v - rx_vel
            geom = np.einsum("ij,ij->i", los, rel) / np.where(ok, rho, 1.0)
            dy = rr - (geom + clk)
            rho2 = rho * rho
            H = np.empty((len(rr), 4))
            H[:, 0] = (-rel[:, 0] / rho + los[:, 0] * geom / rho2
                       + wgs84.OMEGA_EARTH * los[:, 1] / rho)
            H[:, 1] = (-rel[:, 1] / rho + los[:, 1] * geom / rho2
                       - wgs84.OMEGA_EARTH * los[:, 0] / rho)
            H[:, 2] = -rel[:, 2] / rho + los[:, 2] * geom / rho2
            H[:, 3] = 1.0
            ww = np.where(ok, w, 0.0)
            HtWH = (H.T * ww) @ H
            HtWy = (H.T * ww) @ dy

            if use_height:
                r0 = np.linalg.norm(rx)
                if r0 > 0:
                    _, _, halt = wgs84.ecef_to_geodetic(rx)
                    dy_h = self.height_aid - halt
                    hh = np.array([rx[0] / r0, rx[1] / r0, rx[2] / r0, 0.0])
                    HtWH += np.outer(hh, hh) * 100.0
                    HtWy += hh * 100.0 * dy_h

            lam = 10.0 if it < 10 else (1.0 if it < 50 else 0.01)
            HtWH = HtWH + np.diag(np.diag(HtWH) * lam + 1e-6)
            try:
                delta = np.linalg.solve(HtWH, HtWy)
            except np.linalg.LinAlgError:
                return rx, clk, False
            step = np.linalg.norm(delta[:3])
            if step > 500000.0:
                delta = delta * (500000.0 / step)
            rx = rx + delta[:3]
            clk = clk + delta[3]
            if np.linalg.norm(delta[:3]) < CONVERGENCE_M:
                return rx, clk, True
        return rx, clk, False

    def _residuals(self, rx, clk, sat_e, sat_v, rr):
        rx_vel = np.array([-wgs84.OMEGA_EARTH * rx[1],
                           wgs84.OMEGA_EARTH * rx[0], 0.0])
        los = sat_e - rx
        rho = np.linalg.norm(los, axis=1)
        rel = sat_v - rx_vel
        pred = np.einsum("ij,ij->i", los, rel) / np.where(rho >= 1, rho, 1) \
            + clk
        return rr - pred, rho

    # ---- solve ----

    def solve(self) -> Solution:
        out = Solution()
        now = 0
        for s in self.sats.values():
            if s.count:
                now = max(now, max(s.ts))

        # spatial clustering over motion-validated satellites
        sat_list = list(self.sats.values())
        keep = {}
        motion_pos = {}
        vel_usable = {}
        for s in sat_list:
            if s.count < 2:
                continue
            usable = 0
            latest = None
            for i in range(s.count - 1, -1, -1):
                if now > 0 and now - s.ts[i] > MAX_MEAS_AGE_NS:
                    continue
                if self._estimate_velocity(s, i) is not None:
                    usable += 1
                    if latest is None:
                        latest = i
            if latest is not None:
                motion_pos[s.sat_id] = s.ecef[latest]
                vel_usable[s.sat_id] = usable
        if len(motion_pos) >= 3:
            ids = list(motion_pos)
            nb = {i: 0 for i in ids}
            for a in range(len(ids)):
                for b in range(a + 1, len(ids)):
                    d = np.linalg.norm(motion_pos[ids[a]]
                                       - motion_pos[ids[b]])
                    if d < MAX_SAT_CLUSTER_DIST:
                        nb[ids[a]] += 1
                        nb[ids[b]] += 1
            core = max(ids, key=lambda i: (nb[i], vel_usable[i]))
            keep[core] = True
            for s in sat_list:
                if s.sat_id == core:
                    continue
                if s.sat_id in motion_pos:
                    if (np.linalg.norm(motion_pos[s.sat_id]
                                       - motion_pos[core])
                            < MAX_SAT_CLUSTER_DIST):
                        keep[s.sat_id] = True
                else:
                    for i in range(s.count - 1, -1, -1):
                        if now > 0 and now - s.ts[i] > MAX_MEAS_AGE_NS:
                            continue
                        if (np.linalg.norm(s.ecef[i] - motion_pos[core])
                                < MAX_SAT_CLUSTER_DIST):
                            keep[s.sat_id] = True
                        break
        else:
            for s in sat_list:
                for i in range(s.count - 1, -1, -1):
                    if now == 0 or now - s.ts[i] <= MAX_MEAS_AGE_NS:
                        keep[s.sat_id] = True
                        break

        # flatten measurements with velocity estimates
        sat_e, sat_v, rr, sat_idx = [], [], [], []
        sats_used = 0
        for s in sat_list:
            if not keep.get(s.sat_id):
                continue
            chan = self._channel_freq(s, now)
            if chan == 0:
                continue
            contributed = False
            lam = wgs84.C_LIGHT / chan
            for i in range(s.count):
                if now - s.ts[i] > MAX_MEAS_AGE_NS:
                    continue
                vel = self._estimate_velocity(s, i)
                if vel is None:
                    continue
                sat_e.append(s.ecef[i])
                sat_v.append(vel)
                rr.append(-lam * (s.freq[i] - chan))
                sat_idx.append(s.sat_id)
                contributed = True
            if contributed:
                sats_used += 1

        n_meas = len(rr)
        out.n_measurements = n_meas
        out.n_satellites = sats_used
        if n_meas < MIN_MEASUREMENTS or sats_used < MIN_SATELLITES:
            return out

        sat_e = np.array(sat_e)
        sat_v = np.array(sat_v)
        rr = np.array(rr)
        sat_idx = np.array(sat_idx)
        w = np.ones(n_meas)

        # initial estimate
        if self.prev_ecef is not None:
            rx = self.prev_ecef.copy()
            clk = self.prev_clock_drift
        else:
            num = np.zeros(3)
            tot = 0.0
            for s in sat_list:
                if not keep.get(s.sat_id) or s.count == 0:
                    continue
                latest = s.ecef[-1]
                r = np.linalg.norm(latest)
                if r <= 0:
                    continue
                wgt = float(s.count)
                num += latest * (wgs84.WGS84_A / r) * wgt
                tot += wgt
            rx = num / tot if tot > 0 else np.zeros(3)
            clk = 0.0
            if self.height_aid is not None:
                lat0, lon0, _ = wgs84.ecef_to_geodetic(rx)
                rx = wgs84.geodetic_to_ecef(lat0, lon0, self.height_aid)

        use_height = self.height_aid is not None
        rx, clk, converged = self._wls(rx, clk, sat_e, sat_v, rr, w,
                                       use_height)
        if not converged:
            self.prev_ecef = None
            return out

        # 3-sigma outlier rejection + re-solve
        res, rho = self._residuals(rx, clk, sat_e, sat_v, rr)
        valid = rho >= 1.0
        w[~valid] = 0
        n_valid = int(valid.sum())
        rejected = 0
        if n_valid > 4:
            sigma = np.sqrt(np.sum(res[valid] ** 2) / (n_valid - 4))
            outl = valid & (np.abs(res) > OUTLIER_SIGMA * sigma)
            rejected = int(outl.sum())
            w[outl] = 0
            if rejected > 0 and n_valid - rejected >= MIN_MEASUREMENTS:
                rx, clk, converged = self._wls(rx, clk, sat_e, sat_v, rr,
                                               w, use_height)
                if not converged:
                    return out
                n_meas = n_valid - rejected

        # per-satellite residual screening
        res, rho = self._residuals(rx, clk, sat_e, sat_v, rr)
        active = w > 0
        ids = np.unique(sat_idx[active])
        if len(ids) >= 3:
            means = {i: np.mean(np.abs(res[active & (sat_idx == i)]))
                     for i in ids}
            median = float(np.sort(list(means.values()))[len(ids) // 2])
            dropped = [i for i in ids
                       if median > 0 and means[i] > 3.0 * median]
            if dropped:
                for i in dropped:
                    w[sat_idx == i] = 0
                sats_used -= len(dropped)
                remaining = int((w > 0).sum())
                if (remaining >= MIN_MEASUREMENTS
                        and sats_used >= MIN_SATELLITES):
                    n_meas = remaining
                    rx, clk, converged = self._wls(
                        rx, clk, sat_e, sat_v, rr, w, use_height)
                    if not converged:
                        return out
                else:
                    return out

        # HDOP from ENU-rotated covariance
        hdop = 99.9
        act = w > 0
        if act.sum() >= 4:
            rx_vel = np.array([-wgs84.OMEGA_EARTH * rx[1],
                               wgs84.OMEGA_EARTH * rx[0], 0.0])
            los = sat_e[act] - rx
            rho = np.linalg.norm(los, axis=1)
            rel = sat_v[act] - rx_vel
            geom = np.einsum("ij,ij->i", los, rel) / rho
            rho2 = rho * rho
            H = np.empty((int(act.sum()), 4))
            H[:, 0] = (-rel[:, 0] / rho + los[:, 0] * geom / rho2
                       + wgs84.OMEGA_EARTH * los[:, 1] / rho)
            H[:, 1] = (-rel[:, 1] / rho + los[:, 1] * geom / rho2
                       - wgs84.OMEGA_EARTH * los[:, 0] / rho)
            H[:, 2] = -rel[:, 2] / rho + los[:, 2] * geom / rho2
            H[:, 3] = 1.0
            try:
                q = np.linalg.inv(H.T @ H)
                lat, lon, _ = wgs84.ecef_to_geodetic(rx)
                r = wgs84.ecef_to_enu_matrix(lat, lon)
                q_enu = r @ q[:3, :3] @ r.T
                if q_enu[0, 0] + q_enu[1, 1] > 0:
                    hdop = float(np.sqrt(q_enu[0, 0] + q_enu[1, 1]))
            except np.linalg.LinAlgError:
                pass

        # jump guard
        if self.prev_ecef is not None:
            jump = np.linalg.norm(rx - self.prev_ecef)
            if jump > MAX_SOLUTION_JUMP:
                self.jump_reject_count += 1
                if self.jump_reject_count < 5:
                    lat, lon, alt = wgs84.ecef_to_geodetic(self.prev_ecef)
                    return Solution(lat, lon, alt, hdop, n_meas,
                                    sats_used, True)
                self.jump_reject_count = 0
            else:
                self.jump_reject_count = 0

        self.prev_ecef = rx.copy()
        self.prev_clock_drift = clk
        lat, lon, alt = wgs84.ecef_to_geodetic(rx)
        return Solution(lat, lon, alt, hdop, n_meas, sats_used, True)
