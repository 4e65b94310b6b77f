"""The cameramodel class: a camera's description and the inputs of the
solve that made it.

Counterpart of ``mrcal_tpu/cameramodel.py``, host-side numpy.  The
.cameramodel file format is a python-dict literal with keys lensmodel,
intrinsics, rt_cam_ref (and the legacy 'extrinsics' alias), imagersize,
valid_intrinsics_region, icam_intrinsics/icam_extrinsics and an
optimization_inputs blob (np.savez_compressed, then base85), the same
bytes as the JAX package writes, so a model written by either package
reads back in the other with the same arrays.  A model written after a
solve embeds the complete optimization_inputs, from which the
uncertainty is computed.  The reader also takes OpenCV/ROS yaml and json
and the JPL .cahvor format (``cahvor.py``), which write(cahvor=True) and
a file name ending in .cahv, .cahvor or .cahvore write.

The pose conversions run on the CPU: a 6-vector does not go to the card.
"""

import ast
import base64
import io
import re

import numpy as np

from . import poseutils as _pose
from .lensmodels import lensmodel_metadata_and_config, lensmodel_num_params
from .optimize.layout import corresponding_icam_extrinsics

def _host(fn, *args):
    """A pose function of the port on the CPU, returning numpy."""
    return fn(*args, device="cpu").numpy()


def _serialize_optimization_inputs(optimization_inputs):
    """np.savez_compressed, then b85: the reference's format."""
    d = {}
    skip_if_empty = {"do_apply_regularization_unity_cam01",
                     "observations_point_triangulated",
                     "indices_point_triangulated_camintrinsics_camextrinsics"}
    for k, v in optimization_inputs.items():
        if v is None:
            v = ""
        if k in skip_if_empty:
            if isinstance(v, np.ndarray):
                if v.size == 0:
                    continue
            elif not v:
                continue
        d[k] = v
    # on-disk names are the legacy ones (reference writes these)
    for new, old in (("rt_cam_ref", "extrinsics_rt_fromref"),
                     ("rt_ref_frame", "frames_rt_toref")):
        if new in d and old not in d:
            d[old] = d.pop(new)
    b = io.BytesIO()
    np.savez_compressed(b, **d)
    return base64.b85encode(b.getvalue())


def _deserialize_optimization_inputs(data_bytes):
    """Inverse of _serialize_optimization_inputs."""
    raw = np.load(io.BytesIO(base64.b85decode(data_bytes)),
                  allow_pickle=False)
    out = {}
    for k in raw.keys():
        arr = raw[k]
        if arr.shape == ():
            arr = arr.item()
        if isinstance(arr, str) and arr == "":
            arr = None
        out[k] = arr
    for old, new in (("do_optimize_intrinsic_core",
                      "do_optimize_intrinsics_core"),
                     ("do_optimize_intrinsic_distortions",
                      "do_optimize_intrinsics_distortions")):
        if old in out and new not in out:
            out[new] = out.pop(old)
    # we keep the legacy array names internally
    for new, old in (("rt_cam_ref", "extrinsics_rt_fromref"),
                     ("rt_ref_frame", "frames_rt_toref")):
        if new in out and old not in out:
            out[old] = out.pop(new)
    out.pop("calibration_object_width_n", None)
    out.pop("calibration_object_height_n", None)
    return out


class CameramodelParseException(Exception):
    pass


def _parse_as_opencv_or_ros(modelstring):
    """Parse an OpenCV / ROS camera model (yaml or json; the
    camera_calibration_parsers file format or a sensor_msgs/CameraInfo
    dump) into a .cameramodel-formatted string.

    Extrinsics: the yaml's R is R_leftrect_cam and P[:,3]/P[0,0] is the
    scaled rectified translation, so the reference coordinate system is
    the left-rectified camera."""
    try:
        import yaml
        model_in = yaml.safe_load(modelstring)
        if not isinstance(model_in, dict):
            raise ValueError("not a dict")
    except Exception as e_yaml:
        try:
            import json
            model_in = json.loads(modelstring)
            if not isinstance(model_in, dict):
                raise ValueError("not a dict")
        except Exception as e_json:
            raise CameramodelParseException(
                f"Couldn't parse yaml ({e_yaml}) or json ({e_json})")

    def find(key_sequences, dtype, shape):
        """Locate exactly one of the nested key sequences in model_in and
        coerce to the requested dtype/shape (None shape = as-is)."""
        def walk(seq, d, at=""):
            for k in d.keys():
                if isinstance(k, str) and k == seq[0]:
                    if len(seq) == 1:
                        if isinstance(d[k], dict):
                            return None, None
                        return d[k], f"{at}[{k!r}]"
                    if not isinstance(d[k], dict):
                        return None, None
                    return walk(seq[1:], d[k], at=f"{at}[{k!r}]")
            return None, None

        matches = [walk(s, model_in) for s in key_sequences]
        matches = [(m, at) for m, at in matches if m is not None]
        if len(matches) != 1:
            raise CameramodelParseException(
                f"Need exactly one of {key_sequences}; found "
                f"{len(matches)}")
        m, at = matches[0]
        try:
            m = np.array(m, dtype=dtype)
        except Exception:
            raise CameramodelParseException(
                f"Could not parse model{at} as {dtype}")
        if shape is not None:
            try:
                m = m.reshape(shape)
            except Exception:
                raise CameramodelParseException(
                    f"Could not reshape model{at} to {shape}")
            if len(shape) == 0:
                m = m.item()
        return m, at

    M, M_at = find((("camera_matrix", "data"), ("camera_matrix",), ("K",)),
                   float, (3, 3))
    if M[0, 1] != 0 or M[1, 0] != 0 or M[2, 0] != 0 or M[2, 1] != 0 \
            or M[2, 2] != 1:
        raise CameramodelParseException(
            f"model {M_at} should be [fx 0 cx; 0 fy cy; 0 0 1]")
    P, P_at = find((("projection_matrix", "data"), ("projection_matrix",),
                    ("P",)), float, (3, 4))
    if P[1, 3] != 0 or P[2, 3] != 0:
        raise CameramodelParseException(
            f"model {P_at} last column must be [x*fx,0,0]; have {P[:, 3]}")
    try:
        R, _ = find((("rotation", "data"), ("rotation",), ("R",)),
                    float, (3, 3))
    except CameramodelParseException:
        R = np.eye(3)
    # sometimes P=0 or R=0 appear; treat as identity
    if not np.any(P):
        P = P.copy()
        P[:, :3] = np.eye(3)
    if not np.any(R):
        R = np.eye(3)

    lensmodel_name, _ = find((("distortion_model",),), str, ())
    map_lensmodel = dict(plumb_bob="LENSMODEL_OPENCV5",
                         rational_polynomial="LENSMODEL_OPENCV8")
    if lensmodel_name not in map_lensmodel:
        if lensmodel_name == "equidistant":
            raise CameramodelParseException(
                '"equidistant" OpenCV model not supported yet')
        raise CameramodelParseException(
            f'Unknown OpenCV model "{lensmodel_name}". Known: '
            f"{sorted(map_lensmodel)}")
    lensmodel = map_lensmodel[lensmodel_name]

    distortion, D_at = find(
        (("distortion_coefficients", "data"), ("distortion_coefficients",),
         ("D",)), float, None)
    intrinsics = [float(x) for x in (M[0, 0], M[1, 1], M[0, 2], M[1, 2])] \
        + [float(x) for x in np.ravel(distortion)]

    W, _ = find((("image_width",), ("width",)), int, ())
    H, _ = find((("image_height",), ("height",)), int, ())

    if np.sum((R @ R.T - np.eye(3)) ** 2) > 1e-12:
        raise CameramodelParseException(f"R must be a rotation; have {R}")
    Rt_ref_cam = np.zeros((4, 3))
    Rt_ref_cam[:3, :] = R
    Rt_ref_cam[3, :] = -P[:, 3] / P[0, 0]
    rt_cam_ref = _host(_pose.rt_from_Rt, _host(_pose.invert_Rt, Rt_ref_cam))

    return repr(dict(lensmodel=lensmodel,
                     intrinsics=intrinsics,
                     imagersize=[int(W), int(H)],
                     rt_cam_ref=[float(x) for x in rt_cam_ref]))


class cameramodel:
    """A camera model: (lensmodel, intrinsics), imagersize, pose, and
    optionally the complete calibration optimization_inputs."""

    def __init__(self, file_or_model=None, **kwargs):
        self._intrinsics = None
        self._imagersize = None
        self._rt_cam_ref = np.zeros(6)
        self._valid_intrinsics_region = None
        self._optimization_inputs_string = None
        self._icam_intrinsics = None
        self._icam_extrinsics = None

        if file_or_model is not None:
            if isinstance(file_or_model, cameramodel):
                self._copy_from(file_or_model)
            elif hasattr(file_or_model, "read"):
                self._tryread(file_or_model.read(), "file object")
            else:
                with open(str(file_or_model), "r") as f:
                    self._tryread(f.read(), f"file '{file_or_model}'")
            return

        if "optimization_inputs" in kwargs:
            oi = kwargs["optimization_inputs"]
            icam = kwargs.get("icam_intrinsics", 0)
            self.intrinsics(
                (oi["lensmodel"], np.array(oi["intrinsics"][icam])),
                imagersize=np.asarray(oi["imagersizes"][icam]),
                optimization_inputs=oi,
                icam_intrinsics=icam)
            # the camera's pose comes from the solve: a stationary
            # camera's rt_cam_ref is its extrinsics row, a camera at the
            # reference keeps the identity, a moving camera has no single
            # pose
            try:
                ice = corresponding_icam_extrinsics(icam, **oi)
                self._icam_extrinsics = ice
                if ice is not None and ice >= 0:
                    self._rt_cam_ref = np.array(
                        np.asarray(oi["extrinsics_rt_fromref"]
                                   if oi.get("extrinsics_rt_fromref")
                                   is not None
                                   else oi["rt_cam_ref"]).reshape(-1, 6)
                        [ice], dtype=float)
            except ValueError:
                pass          # moving camera: no single extrinsics row
            return

        intrinsics = kwargs.get("intrinsics")
        if intrinsics is not None:
            self._intrinsics = (str(intrinsics[0]),
                                np.array(intrinsics[1], dtype=float))
        if kwargs.get("imagersize") is not None:
            self._imagersize = np.asarray(kwargs["imagersize"], dtype=int)
        for k in ("extrinsics_rt_fromref", "rt_cam_ref"):
            if kwargs.get(k) is not None:
                self._rt_cam_ref = np.array(kwargs[k], dtype=float)
        if kwargs.get("extrinsics_rt_toref") is not None:
            self._rt_cam_ref = _host(_pose.invert_rt,
                                     kwargs["extrinsics_rt_toref"])
        if kwargs.get("extrinsics_Rt_fromref") is not None:
            self._rt_cam_ref = _host(_pose.rt_from_Rt,
                                     kwargs["extrinsics_Rt_fromref"])
        if kwargs.get("extrinsics_Rt_toref") is not None:
            self._rt_cam_ref = _host(_pose.invert_rt, _host(
                _pose.rt_from_Rt, kwargs["extrinsics_Rt_toref"]))
        if kwargs.get("valid_intrinsics_region") is not None:
            self._valid_intrinsics_region = np.asarray(
                kwargs["valid_intrinsics_region"], dtype=float)

    def _copy_from(self, other):
        self._intrinsics = (other._intrinsics[0],
                            np.array(other._intrinsics[1]))
        self._imagersize = np.array(other._imagersize)
        self._rt_cam_ref = np.array(other._rt_cam_ref)
        self._valid_intrinsics_region = (
            None if other._valid_intrinsics_region is None
            else np.array(other._valid_intrinsics_region))
        self._optimization_inputs_string = other._optimization_inputs_string
        self._icam_intrinsics = other._icam_intrinsics
        self._icam_extrinsics = other._icam_extrinsics

    # ------------------------------------------------------------------ I/O
    def _tryread(self, modelstring, what):
        """Parse a model in a supported on-disk format: native
        .cameramodel, OpenCV/ROS yaml/json (camera_calibration_parsers /
        sensor_msgs/CameraInfo), or JPL .cahvor."""
        errors = {}
        try:
            self._read_into_self(modelstring)
            return
        except CameramodelParseException as e:
            errors["cameramodel"] = e
        try:
            self._read_into_self(_parse_as_opencv_or_ros(modelstring))
            return
        except CameramodelParseException as e:
            errors["yaml_or_json"] = e
        try:
            from . import cahvor
            self._copy_from(cahvor.read_from_string(modelstring))
            return
        except Exception as e:
            errors["cahvor"] = e
        raise Exception(f"Couldn't parse {what}. Errors for each attempt: "
                        f"{errors}")

    def _read_into_self(self, s):
        try:
            model = ast.literal_eval(s)
        except (ValueError, SyntaxError, TypeError, MemoryError,
                RecursionError):
            raise CameramodelParseException("Failed to parse cameramodel")
        if "lensmodel" not in model or "intrinsics" not in model:
            raise CameramodelParseException(
                "cameramodel must have at least 'lensmodel' and 'intrinsics'")
        lm = model["lensmodel"]
        if isinstance(lm, bytes):
            lm = lm.decode()
        # legacy model-name translations (DISTORTION_... -> LENSMODEL_...)
        lm = re.sub(r"^DISTORTION_", "LENSMODEL_", lm)
        self._intrinsics = (lm, np.array(model["intrinsics"], dtype=float))
        n_expected = lensmodel_num_params(lm)
        if self._intrinsics[1].shape != (n_expected,):
            raise CameramodelParseException(
                f"Expected {n_expected} intrinsics for {lm}; got "
                f"{self._intrinsics[1].shape}")
        if "imagersize" in model:
            self._imagersize = np.array(model["imagersize"], dtype=int)
        elif "imager_size" in model:
            self._imagersize = np.array(model["imager_size"], dtype=int)
        else:
            # the reference's parser rejects a model without one
            raise CameramodelParseException(
                "cameramodel must have 'imagersize'")
        if self._imagersize.shape != (2,):
            raise CameramodelParseException(
                "'imagersize' must have shape (2,)")
        rt = model.get("rt_cam_ref", model.get("extrinsics"))
        if rt is not None:
            self._rt_cam_ref = np.array(rt, dtype=float)
            if self._rt_cam_ref.shape != (6,):
                raise CameramodelParseException(
                    "'rt_cam_ref' must have shape (6,)")
        if model.get("valid_intrinsics_region") is not None:
            self._valid_intrinsics_region = np.array(
                model["valid_intrinsics_region"], dtype=float)
        if "icam_intrinsics" in model:
            self._icam_intrinsics = int(model["icam_intrinsics"])
        if "icam_extrinsics" in model:
            self._icam_extrinsics = int(model["icam_extrinsics"])
        oi = model.get("optimization_inputs")
        if oi is not None:
            if isinstance(oi, str):
                oi = oi.encode()
            self._optimization_inputs_string = oi

    def _write(self, f, note=None):
        if note is not None:
            for line in note.splitlines():
                f.write("# " + line + "\n")
        f.write("{\n")
        f.write("    'lensmodel':  '{}',\n\n".format(self._intrinsics[0]))
        N = len(self._intrinsics[1])
        if lensmodel_metadata_and_config(self._intrinsics[0])["has_core"]:
            f.write("    # intrinsics are fx,fy,cx,cy,distortion0,"
                    "distortion1,....\n")
        f.write(("    'intrinsics': [" + " {:.10g}," * N + "],\n\n").format(
            *self._intrinsics[1]))
        if self._valid_intrinsics_region is not None:
            f.write("    'valid_intrinsics_region': [\n")
            for row in self._valid_intrinsics_region:
                f.write("    [ {:.10g}, {:.10g} ],\n".format(*row))
            f.write("],\n\n")
        f.write(("    'rt_cam_ref': [" + " {:.10g}," * 6 + "],\n").format(
            *self._rt_cam_ref))
        f.write(("    'extrinsics': [" + " {:.10g}," * 6 +
                 "], # for compatibility with mrcal < 2.5\n\n").format(
            *self._rt_cam_ref))
        f.write("    'imagersize': [ {:d}, {:d},],\n\n".format(
            *(int(x) for x in self._imagersize)))
        if self._icam_intrinsics is not None:
            f.write("    'icam_intrinsics': {:d},\n".format(
                self._icam_intrinsics))
        if self._icam_extrinsics is not None:
            f.write("    'icam_extrinsics': {:d},\n".format(
                self._icam_extrinsics))
        f.write("\n")
        if self._optimization_inputs_string is not None:
            f.write("    'optimization_inputs': "
                    f"{self._optimization_inputs_string},\n\n")
        f.write("}\n")

    def write(self, f, *, note=None, cahvor=False):
        if isinstance(f, str):
            with open(f, "w") as fh:
                self.write(fh, note=note, cahvor=cahvor or bool(
                    re.match(r".*\.cahv(or(e)?)?$", f)))
        elif cahvor:
            from . import cahvor as _cahvor
            _cahvor.write(f, self, note)
        else:
            self._write(f, note)

    def __str__(self):
        b = io.StringIO()
        self._write(b)
        return b.getvalue()

    def __repr__(self):
        return f"cameramodel({self._intrinsics[0]})"

    # ------------------------------------------------------------ accessors
    def intrinsics(self, intrinsics=None, *, imagersize=None,
                   optimization_inputs=None, icam_intrinsics=None,
                   icam_extrinsics=None):
        if intrinsics is None and imagersize is None \
                and optimization_inputs is None and icam_intrinsics is None:
            return self._intrinsics
        if intrinsics is not None:
            self._intrinsics = (str(intrinsics[0]),
                                np.array(intrinsics[1], dtype=float))
        if imagersize is not None:
            self._imagersize = np.asarray(imagersize, dtype=int)
        if optimization_inputs is not None:
            self._optimization_inputs_string = \
                _serialize_optimization_inputs(optimization_inputs)
            self._icam_intrinsics = icam_intrinsics
            if icam_extrinsics is not None:
                self._icam_extrinsics = icam_extrinsics

    def imagersize(self, *args):
        return np.array(self._imagersize) \
            if self._imagersize is not None else None

    def extrinsics_rt_fromref(self, rt=None):
        if rt is None:
            return np.array(self._rt_cam_ref)
        self._rt_cam_ref = np.array(rt, dtype=float)

    rt_cam_ref = extrinsics_rt_fromref

    def extrinsics_rt_toref(self, rt=None):
        if rt is None:
            return _host(_pose.invert_rt, self._rt_cam_ref)
        self._rt_cam_ref = _host(_pose.invert_rt, np.asarray(rt, float))

    rt_ref_cam = extrinsics_rt_toref

    def extrinsics_Rt_fromref(self, Rt=None):
        if Rt is None:
            return _host(_pose.Rt_from_rt, self._rt_cam_ref)
        self._rt_cam_ref = _host(_pose.rt_from_Rt, np.asarray(Rt, float))

    Rt_cam_ref = extrinsics_Rt_fromref

    def extrinsics_Rt_toref(self, Rt=None):
        if Rt is None:
            return _host(_pose.Rt_from_rt,
                         _host(_pose.invert_rt, self._rt_cam_ref))
        self._rt_cam_ref = _host(_pose.invert_rt, _host(
            _pose.rt_from_Rt, np.asarray(Rt, float)))

    Rt_ref_cam = extrinsics_Rt_toref

    def valid_intrinsics_region(self, region=None):
        if region is None:
            return (None if self._valid_intrinsics_region is None
                    else np.array(self._valid_intrinsics_region))
        self._valid_intrinsics_region = np.array(region, dtype=float)

    def optimization_inputs(self):
        """The complete solve inputs embedded in this model (or None)."""
        if self._optimization_inputs_string is None:
            return None
        return _deserialize_optimization_inputs(
            self._optimization_inputs_string)

    def icam_intrinsics(self):
        return self._icam_intrinsics

    def icam_extrinsics(self):
        return self._icam_extrinsics
