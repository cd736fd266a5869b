"""Camera noise calibration tables (physical constants, stored as arrays).

Numpy copy of ``pnnp_tpu/physics/calibration.py``: the published sensor
calibrations (reference: data_process/process.py:215-308) as dense arrays.

Two families:
  * log-linear regression models per camera/"conversion-gain mode"
    (``CAMERA_REGRESSION``): log-sigma as linear fits of log-K;
  * per-ISO point calibrations (``ISO_TABLES``): SonyA7S2 has 28 calibrated
    ISOs, IMX686 has 2.

Plus ``HALF_CLIP``, the proxy's legal ISO ladder, :func:`iso_index` and the
user noiseparam loaders (:func:`load_noiseparam_h5`,
:func:`table_with_noiseparam`).
"""

from __future__ import annotations

import numpy as np

DUAL_ISO_CAMERAS = ("SonyA7S2",)
HALF_CLIP = 2  # reference: data_process/process.py:19

# NoiseFlow / proxy "legal ISO" ladder (reference: archs/flow_layers/gain.py:69-70).
LEGAL_ISO = np.array(
    [50, 64, 80, 100, 125, 160, 200, 250, 320, 400, 500, 640, 800, 1000, 1250, 1600,
     2000, 2500, 3200, 4000, 5000, 6400, 8000, 10000, 12800, 16000, 20000, 25600,
     32000, 40000, 51200],
    np.float32,
)

CAMERA_REGRESSION = {
    "NikonD850": dict(
        Kmin=1.2, Kmax=2.4828, lam=-0.26, q=1 / 2**14, wp=16383, bl=512,
        sigTLk=0.906, sigTLb=-0.6754, sigTLsig=0.035165,
        sigRk=0.8322, sigRb=-2.3326, sigRsig=0.301333,
        sigGsk=0.8322, sigGsb=-0.1754, sigGssig=0.035165,
    ),
    "IMX686": dict(  # ISO-640~6400
        Kmin=-0.19118, Kmax=2.16820, lam=0.102, q=1 / 2**10, wp=1023, bl=64,
        sigTLk=0.85187, sigTLb=0.07991, sigTLsig=0.02921,
        sigRk=0.87611, sigRb=-2.11455, sigRsig=0.03274,
        sigGsk=0.85187, sigGsb=0.67991, sigGssig=0.02921,
    ),
    "SonyA7S2_lowISO": dict(
        Kmin=-1.67214, Kmax=0.42228, lam=-0.026, q=1 / 2**14, wp=16383, bl=512,
        sigRk=0.78782, sigRb=-0.34227, sigRsig=0.02832,
        sigTLk=0.74043, sigTLb=0.86182, sigTLsig=0.00712,
        sigGsk=0.82966, sigGsb=1.49343, sigGssig=0.00359,
        sigReadk=0.82879, sigReadb=1.50601, sigReadsig=0.00362,
        uReadk=0.01472, uReadb=0.01129, uReadsig=0.00034,
    ),
    "SonyA7S2_highISO": dict(
        Kmin=0.64567, Kmax=2.51606, lam=-0.025, q=1 / 2**14, wp=16383, bl=512,
        sigRk=0.62945, sigRb=-1.51040, sigRsig=0.02609,
        sigTLk=0.74901, sigTLb=-0.12348, sigTLsig=0.00638,
        sigGsk=0.82878, sigGsb=0.44162, sigGssig=0.00153,
        sigReadk=0.82645, sigReadb=0.45061, sigReadsig=0.00156,
        uReadk=0.00385, uReadb=0.00674, uReadsig=0.00039,
    ),
    "CRVD": dict(
        Kmin=1.31339, Kmax=3.95448, lam=0.015, q=1 / 2**12, wp=4095, bl=240,
        sigRk=0.93368, sigRb=-2.19692, sigRsig=0.02473,
        sigGsk=0.95387, sigGsb=0.01552, sigGssig=0.00855,
        sigTLk=0.95495, sigTLb=0.01618, sigTLsig=0.00790,
    ),
}

# SonyA7S2 per-ISO calibration (reference: data_process/process.py:260-289).
# Columns: iso, Kmax, lam, sigGs, sigGssig, sigTL, sigTLsig, sigR, sigRsig, biassig
_SONY_ROWS = np.array([
    [50, 0.047815, 0.1474653, 1.0164667, 0.005272454, 0.70727646, 0.004360543, 0.13997398, 0.0064381803, 0.010093017],
    [64, 0.0612032, 0.13243394, 1.0509665, 0.008081373, 0.71535635, 0.0056863446, 0.14346549, 0.006400559, 0.008690166],
    [80, 0.076504, 0.1121489, 1.180899, 0.011333668, 0.7799473, 0.009347968, 0.19540153, 0.008197397, 0.0107246125],
    [100, 0.09563, 0.14875287, 1.0067395, 0.0033682834, 0.70181876, 0.0037532174, 0.1391465, 0.006530218, 0.007235429],
    [125, 0.1195375, 0.12904578, 1.0279676, 0.007364685, 0.6961967, 0.0048687346, 0.14485553, 0.006731584, 0.008026363],
    [160, 0.153008, 0.094135, 1.1293099, 0.008340453, 0.7258587, 0.008032158, 0.19755602, 0.0082754735, 0.0101351],
    [200, 0.19126, 0.07902429, 1.2926387, 0.012171176, 0.8117464, 0.010250768, 0.22815849, 0.010726711, 0.011413908],
    [250, 0.239075, 0.051688068, 1.4345995, 0.01606571, 0.8630922, 0.013844714, 0.26271912, 0.0130637, 0.013569083],
    [320, 0.306016, 0.040700804, 1.7481371, 0.019626873, 1.0334468, 0.017629284, 0.3097104, 0.016202712, 0.017825918],
    [400, 0.38252, 0.0222538, 2.0595572, 0.024872316, 1.1816813, 0.02505812, 0.36209714, 0.01994737, 0.021005306],
    [500, 0.47815, -0.0031342343, 2.3956928, 0.030144656, 1.31772, 0.028629242, 0.42528257, 0.025104137, 0.02981831],
    [640, 0.612032, 0.002566592, 2.9662898, 0.045661453, 1.6474211, 0.04671843, 0.48839623, 0.031589635, 0.10000693],
    [800, 0.76504, -0.008199721, 3.5475867, 0.052318197, 1.9346539, 0.046128694, 0.5723769, 0.037824076, 0.025339302],
    [1000, 0.9563, -0.021061005, 4.2727833, 0.06972333, 2.2795107, 0.059203167, 0.6845563, 0.04879781, 0.027911892],
    [1250, 1.195375, -0.032423194, 5.177596, 0.092677385, 2.708437, 0.07622563, 0.8177013, 0.06162229, 0.03293372],
    [1600, 1.53008, -0.0441045, 6.29925, 0.1153261, 3.2283993, 0.09118158, 0.988786, 0.078567736, 0.03877672],
    [2000, 1.9126, -0.012963797, 2.653871, 0.015890995, 1.4356787, 0.02178686, 0.33124214, 0.018801652, 0.01570677],
    [2500, 2.39075, -0.027097283, 3.200225, 0.019307792, 1.6897862, 0.025873765, 0.38264316, 0.023769397, 0.018728448],
    [3200, 3.06016, -0.034863412, 3.9193838, 0.02649232, 2.0417721, 0.032873377, 0.44543457, 0.030114045, 0.021355819],
    [4000, 3.8252, -0.043700505, 4.8015847, 0.03781628, 2.4629273, 0.042401053, 0.52347374, 0.03929801, 0.026152484],
    [5000, 4.7815, -0.053150143, 5.8995814, 0.0625814, 2.9761007, 0.061326735, 0.6190265, 0.05335372, 0.058574405],
    [6400, 6.12032, -0.07517104, 7.1163535, 0.08435366, 3.4502964, 0.08226275, 0.7218788, 0.0642334, 0.059074216],
    [8000, 7.6504, -0.08208357, 8.916516, 0.12763213, 4.269624, 0.13381928, 0.87760293, 0.07389065, 0.084842026],
    [10000, 9.563, -0.073289566, 11.291476, 0.1639773, 5.495318, 0.16279395, 1.0522343, 0.094359785, 0.107438326],
    [12800, 12.24064, -0.06495205, 14.245901, 0.17283991, 7.038261, 0.18822834, 1.2749791, 0.120479785, 0.0944684],
    [16000, 15.3008, -0.060692135, 17.833515, 0.19809262, 8.877547, 0.23338738, 1.5559287, 0.15791349, 0.09725099],
    [20000, 19.126, -0.060213074, 22.084776, 0.21820943, 11.002351, 0.28806436, 1.8810822, 0.18937257, 0.4984733],
    [25600, 24.48128, -0.09089118, 25.853043, 0.35371417, 12.175712, 0.4215717, 2.2760193, 0.2609267, 0.37568903],
], np.float64)

_IMX686_ROWS = np.array([
    # iso, Kmax, lam, sigGs, sigGssig, sigTL, sigTLsig, sigR, sigRsig, biassig
    [100, 0.083805, 0.015, 0.6926457, 0.002096, 0.67998, 0.0, 0.23668, 0.0, 0.0],
    [6400, 8.74253, 0.015, 14.30362, 0.06967, 12.8901, 0.0, 0.0, 0.0, 0.0],
], np.float64)

_IMX686_BIAS = np.array(
    [[0.0, 0.0, 0.0, 0.0], [-0.08113494, -0.04906388, -0.9408157, -1.2048522]],
    np.float64,
)


def _make_table(rows, q, wp, bl, bias=None):
    t = {
        "iso": rows[:, 0].astype(np.float32),
        "Kmax": rows[:, 1].astype(np.float32),
        "lam": rows[:, 2].astype(np.float32),
        "sigGs": rows[:, 3].astype(np.float32),
        "sigGssig": rows[:, 4].astype(np.float32),
        "sigTL": rows[:, 5].astype(np.float32),
        "sigTLsig": rows[:, 6].astype(np.float32),
        "sigR": rows[:, 7].astype(np.float32),
        "sigRsig": rows[:, 8].astype(np.float32),
        "biassig": rows[:, 9].astype(np.float32),
        "q": np.float32(q),
        "wp": np.float32(wp),
        "bl": np.float32(bl),
    }
    n = len(rows)
    t["bias"] = (np.zeros((n, 4)) if bias is None else bias).astype(np.float32)
    return t


ISO_TABLES = {
    "SonyA7S2": _make_table(_SONY_ROWS, q=6.103515625e-05, wp=16383, bl=512),
    "IMX686": _make_table(_IMX686_ROWS, q=1 / 2**10, wp=1023, bl=64, bias=_IMX686_BIAS),
}

# K(iso) linear model used for SonyA7S2 when an ISO is not in the table
# (reference: data_process/process.py:455, runfiles ISO2K: [0.0009546, -0.00193]).
SONY_ISO2K = (0.0009546, -0.00193)


def iso_index(camera_type: str, iso) -> int:
    """Row index of ``iso`` in the camera's point-calibration table."""
    table = ISO_TABLES[camera_type]
    idx = np.where(table["iso"] == float(iso))[0]
    if len(idx) == 0:
        raise KeyError(f"ISO {iso} not calibrated for {camera_type}")
    return int(idx[0])


# -- user-supplied per-ISO calibration (noiseparam-iso-N.h5) -----------------
# Constants the reference hardcodes alongside the h5-derived values
# (reference: data_process/phone_datasets.py:99-112 — K/"Kmax" and the
# per-channel read bias are NOT read from the file).
IMX686_NOISEPARAM_KMAX = 8.7425333
IMX686_NOISEPARAM_BIAS = np.array(
    [-0.08113494, -0.04906388, -0.9408157, -1.2048522], np.float32)


def load_noiseparam_h5(ds_dir, iso: int = 6400):
    """Load a user's per-ISO IMX686 calibration file if present.

    Mirrors reference phone_datasets.py:99-112: reads
    ``{ds_dir}/noiseparam-iso-{iso}.h5`` and reduces the per-frame calibration
    arrays to the sampling-law parameters (means + jitter stds). Returns the
    noiseparam dict, or None when ``ds_dir`` is unset / the file is absent
    (callers then fall back to the baked ``ISO_TABLES`` values).
    """
    import os

    if not ds_dir:
        return None
    path = os.path.join(ds_dir, f"noiseparam-iso-{iso}.h5")
    if not os.path.exists(path):
        return None
    import h5py

    with h5py.File(path, "r") as f:
        lam = np.asarray(f["lam"])
        sigGs = np.asarray(f["sigmaGs"])
        sigTL = np.asarray(f["sigmaTL"])
        sigR = np.asarray(f["sigmaR"])
        mean_read = np.asarray(f["meanRead"])
    return {
        "K": IMX686_NOISEPARAM_KMAX,
        "lam": float(np.mean(lam)),
        "sigGs": float(np.mean(sigGs)), "sigGssig": float(np.std(sigGs)),
        "sigTL": float(np.mean(sigTL)), "sigTLsig": float(np.std(sigTL)),
        "sigR": float(np.mean(sigR)), "sigRsig": float(np.std(sigR)),
        "bias": IMX686_NOISEPARAM_BIAS.copy(),
        "biassig": np.std(mean_read, axis=1).astype(np.float32),
        "q": 1 / 2**10, "wp": 1023, "bl": 64,
    }


def table_with_noiseparam(camera_type: str, iso, noiseparam: dict):
    """Copy of ``ISO_TABLES[camera_type]`` with the row for ``iso`` replaced
    by a user-supplied noiseparam dict (see :func:`load_noiseparam_h5`)."""
    base = ISO_TABLES[camera_type]
    i = iso_index(camera_type, iso)
    table = {k: (np.array(v, copy=True) if isinstance(v, np.ndarray) else v)
             for k, v in base.items()}
    table["Kmax"][i] = noiseparam["K"]
    for k in ("lam", "sigGs", "sigGssig", "sigTL", "sigTLsig", "sigR",
              "sigRsig"):
        table[k][i] = noiseparam[k]
    table["bias"][i] = np.asarray(noiseparam["bias"], np.float32)
    return table
