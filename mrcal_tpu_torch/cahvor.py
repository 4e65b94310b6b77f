"""The JPL .cahvor/.cahvore text format and the JPL toolkit's
transforms.txt.

Counterpart of ``mrcal_tpu/cahvor.py``, host-side numpy.  A CAHV(OR(E))
file stores the camera as the vectors C, A, H, V (the center, the
optical axis, and the horizontal and vertical image-plane vectors), then
O and R (the distortion axis and the radial terms) and E (the entrance
pupil's motion).  LENSMODEL_CAHVOR's [fx, fy, cx, cy, alpha, beta, r0,
r1, r2] and LENSMODEL_CAHVORE's added [e0, e1, e2] and linearity map to
and from them; a CAHV file is a LENSMODEL_PINHOLE model.  The writer
gives the JAX package's bytes for the same model.

The pose conversions run on the CPU: a 3-vector does not go to the card.
"""

import io
import re

import numpy as np

from . import poseutils as _pose
from .lensmodels import parse_lensmodel


def _host(fn, *args):
    """A pose function of the port on the CPU, returning numpy."""
    return fn(*args, device="cpu").numpy()


def _parse_keyvalues(f):
    """The `key = values` lines of a file, '#' comments skipped: numeric
    values as float arrays, the rest as strings."""
    kv = {}
    for line in f:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = re.match(r"([A-Za-z_][A-Za-z0-9_()' ]*?)\s*=\s*(.*)", line)
        if not m:
            continue
        key = m.group(1).strip()
        vals = m.group(2).split()
        try:
            kv[key] = np.array([float(v) for v in vals])
        except ValueError:
            kv[key] = m.group(2)
    return kv


def _axis_angles(o_cam, clip):
    """(alpha, beta) of the optical axis o_cam in camera coordinates."""
    s = np.clip(o_cam[1], -1, 1) if clip else o_cam[1]
    return np.arctan2(o_cam[0], o_cam[2]), np.arcsin(s)


def read(f):
    """A cameramodel from a .cahvor file: a file name, an open file, or a
    cameramodel (returned as it is)."""
    from .cameramodel import cameramodel
    if isinstance(f, cameramodel):
        return f
    if isinstance(f, str):
        with open(f) as fh:
            kv = _parse_keyvalues(fh)
    else:
        kv = _parse_keyvalues(f)

    for key in ("C", "A", "H", "V"):
        if key not in kv:
            raise Exception(f".cahvor file missing '{key}'")
    C = kv["C"][:3]
    A = kv["A"][:3]
    Hv = kv["H"][:3]
    Vv = kv["V"][:3]

    # H = fx H' + cx A, V = fy V' + cy A, with H', V', A orthonormal
    hs = np.linalg.norm(np.cross(Hv, A))
    vs = np.linalg.norm(np.cross(Vv, A))
    hc = np.dot(Hv, A)
    vc = np.dot(Vv, A)
    Hp = (Hv - hc * A) / hs
    Vp = (Vv - vc * A) / vs
    U, _, Vt = np.linalg.svd(np.stack([Hp, Vp, A], axis=0))
    R_cam_ref = U @ Vt
    rt_cam_ref = np.concatenate([_host(_pose.r_from_R, R_cam_ref),
                                 -R_cam_ref @ C])

    if "E" in kv:
        alpha, beta = _axis_angles(R_cam_ref @ kv["O"][:3], clip=False)
        linearity = float(kv["T"][0]) if "T" in kv else 1.0
        intr = np.array([hs, vs, hc, vc, alpha, beta, *kv["R"][:3],
                         *kv["E"][:3]])
        lensmodel = f"LENSMODEL_CAHVORE_linearity={linearity:.2f}"
    elif "O" in kv:
        alpha, beta = _axis_angles(R_cam_ref @ kv["O"][:3], clip=True)
        intr = np.array([hs, vs, hc, vc, alpha, beta, *kv["R"][:3]])
        lensmodel = "LENSMODEL_CAHVOR"
    else:
        intr = np.array([hs, vs, hc, vc])
        lensmodel = "LENSMODEL_PINHOLE"

    dims = kv.get("Dimensions")
    imagersize = (np.array(dims[:2], dtype=int) if dims is not None
                  else np.array([int(hc * 2 + 1), int(vc * 2 + 1)]))
    return cameramodel(intrinsics=(lensmodel, intr), imagersize=imagersize,
                       rt_cam_ref=rt_cam_ref)


def write(f, model, note=None):
    """Write a cameramodel to the open file f in the .cahvor format: CAHV
    for a model without CAHVOR distortions, CAHVOR, or CAHVORE3 with its
    linearity as T."""
    lensmodel, intr = model.intrinsics()
    fx, fy, cx, cy = intr[:4]
    rt = model.extrinsics_rt_fromref()
    R_cam_ref = _host(_pose.R_from_r, rt[:3])
    C = -R_cam_ref.T @ rt[3:]
    Hp, Vp, A = R_cam_ref[0], R_cam_ref[1], R_cam_ref[2]
    cahvor = lensmodel == "LENSMODEL_CAHVOR"
    cahvore = lensmodel.startswith("LENSMODEL_CAHVORE")

    def wline(k, v):
        f.write(f"{k} = " + " ".join(f"{x:.12g}" for x in v) + "\n")

    if note is not None:
        for line in note.splitlines():
            f.write("# " + line + "\n")
    W, H = model.imagersize()
    f.write(f"Dimensions = {W} {H}\n")
    if cahvor:
        f.write("Model = CAHVOR = perspective, distortion\n")
    elif cahvore:
        f.write("Model = CAHVORE3 = general\n")
    else:
        f.write("Model = CAHV = perspective, linear\n")
    wline("C", C)
    wline("A", A)
    wline("H", fx * Hp + cx * A)
    wline("V", fy * Vp + cy * A)
    if cahvor or cahvore:
        alpha, beta = intr[4], intr[5]
        o_cam = np.array([np.sin(alpha) * np.cos(beta), np.sin(beta),
                          np.cos(alpha) * np.cos(beta)])
        wline("O", R_cam_ref.T @ o_cam)
        wline("R", intr[6:9])
        if cahvore:
            wline("E", intr[9:12])
            f.write(f"T = {parse_lensmodel(lensmodel).linearity:.12g}\n")


_FLOAT = r'[-+]?(?:\d+(?:\.\d*)?|\.\d+)(?:[eE][-+]?\d+)?'
_POSITION = r'\(\s*({f})\s+({f})\s+({f})\s*\)'.format(f=_FLOAT)
_QUATERNION = r'\(\s*({f})\s+({f})\s+({f})\s+({f})\s*\)'.format(f=_FLOAT)


def read_transforms(f):
    """Parse a JPL toolkit transforms.txt (a file name or an open file)
    of the lines

        ins2veh      = (x y z) (qw qx qy qz)
        cam2ins[<i>] = (x y z) (qw qx qy qz)

    into {'veh_from_ins': Rt, 'ins_from_camera': {i: Rt}}."""
    if isinstance(f, str):
        with open(f) as fh:
            return read_transforms(fh)
    out = dict(veh_from_ins=None, ins_from_camera={})

    def Rt(m, ofs):
        g = [float(m.group(i + ofs)) for i in range(7)]
        # the file's x y z qw qx qy qz as qt = (qw qx qy qz, x y z)
        return _host(_pose.Rt_from_qt, np.array(g[3:7] + g[0:3]))

    for line in f:
        if re.match(r'^\s*#|^\s*$', line):
            continue
        m = re.match(r'\s*ins2veh\s*=\s*{p}\s*{q}\s*$'.format(
            p=_POSITION, q=_QUATERNION), line.rstrip())
        if m:
            if out['veh_from_ins'] is not None:
                raise Exception("corrupt transforms: duplicate ins2veh")
            out['veh_from_ins'] = Rt(m, 1)
            continue
        m = re.match(r'\s*cam2ins\s*\[(\d+)\]\s*=\s*{p}\s*{q}\s*$'.format(
            p=_POSITION, q=_QUATERNION), line.rstrip())
        if m:
            i = int(m.group(1))
            if i in out['ins_from_camera']:
                raise Exception(f"corrupt transforms: duplicate cam2ins[{i}]")
            out['ins_from_camera'][i] = Rt(m, 2)
            continue
        raise Exception("transforms.txt: only 'ins2veh' and 'cam2ins' "
                        f"lines are understood; got {line!r}")
    if out['veh_from_ins'] is None:
        raise Exception("transforms file incomplete: no ins2veh")
    return out


def read_from_string(s):
    """A cameramodel from the text of a .cahvor file."""
    return read(io.StringIO(s))
