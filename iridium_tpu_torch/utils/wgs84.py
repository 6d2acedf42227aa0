"""WGS-84 / physical constants and coordinate conversions.

Parity source: reference `wgs84.h:15-92` (constants, Bowring-iteration
ECEF<->geodetic, ECEF->ENU rotation).
"""

from __future__ import annotations

import math

import numpy as np

WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
WGS84_B = WGS84_A * (1.0 - WGS84_F)
WGS84_E2 = 2.0 * WGS84_F - WGS84_F * WGS84_F

GM_EARTH = 3.986004418e14
C_LIGHT = 299792458.0
OMEGA_EARTH = 7.2921150e-5

IR_CARRIER_FREQ = 1_626_000_000.0
IR_LAMBDA = C_LIGHT / IR_CARRIER_FREQ


def geodetic_to_ecef(lat_deg: float, lon_deg: float, alt_m: float):
    lat = math.radians(lat_deg)
    lon = math.radians(lon_deg)
    slat, clat = math.sin(lat), math.cos(lat)
    slon, clon = math.sin(lon), math.cos(lon)
    n = WGS84_A / math.sqrt(1.0 - WGS84_E2 * slat * slat)
    return np.array([(n + alt_m) * clat * clon,
                     (n + alt_m) * clat * slon,
                     (n * (1.0 - WGS84_E2) + alt_m) * slat])


def ecef_to_geodetic(ecef):
    x, y, z = float(ecef[0]), float(ecef[1]), float(ecef[2])
    p = math.hypot(x, y)
    lon = math.degrees(math.atan2(y, x))
    lat = math.atan2(z, p * (1.0 - WGS84_E2))
    for _ in range(5):
        slat = math.sin(lat)
        n = WGS84_A / math.sqrt(1.0 - WGS84_E2 * slat * slat)
        lat = math.atan2(z + WGS84_E2 * n * slat, p)
    slat = math.sin(lat)
    n = WGS84_A / math.sqrt(1.0 - WGS84_E2 * slat * slat)
    alt = p / math.cos(lat) - n
    return math.degrees(lat), lon, alt


def ecef_to_enu_matrix(lat_deg: float, lon_deg: float) -> np.ndarray:
    lat = math.radians(lat_deg)
    lon = math.radians(lon_deg)
    slat, clat = math.sin(lat), math.cos(lat)
    slon, clon = math.sin(lon), math.cos(lon)
    return np.array([
        [-slon, clon, 0.0],
        [-slat * clon, -slat * slon, clat],
        [clat * clon, clat * slon, slat],
    ])
