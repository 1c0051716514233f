"""Serializable project model: everything a render needs, as plain data.

Port of ``wayverb_tpu.combined.model``: the same dataclasses, the same JSON
(a project file written by either package loads in the other), presets and
output naming; capsules build the port's attenuators and the surface table
is the port's ``Surface`` on a device.

The reference holds this as an observable cereal-serialized tree
(``combined/model/persistent.h`` — sources, receivers with capsule lists,
materials, solver quality params, output format) with presets.  Here it is
plain dataclasses with JSON round-trip — the observability layer belongs to
a UI, not the engine.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Tuple

import torch

from wayverb_tpu_torch.core.attenuator import Hrtf, Microphone
from wayverb_tpu_torch.core.orientation import Orientation
from wayverb_tpu_torch.core.surfaces import Surface

Vec3 = Tuple[float, float, float]


@dataclasses.dataclass
class CapsuleModel:
    """One output channel of a receiver."""

    name: str = "omni"
    kind: str = "microphone"        # "microphone" | "hrtf"
    shape: float = 0.0              # microphone polar shape
    channel: int = 0                # hrtf ear
    pointing: Vec3 = (0.0, 0.0, 1.0)

    def build(self, receiver_pointing: Vec3 = (0.0, 0.0, 1.0)):
        """The port's ``Microphone`` or ``Hrtf`` pointing along the
        capsule's own ``pointing``; ``receiver_pointing`` is not applied,
        as in the reference."""
        orientation = Orientation(pointing=tuple(self.pointing))
        if self.kind == "microphone":
            return Microphone(orientation=orientation, shape=self.shape)
        if self.kind == "hrtf":
            return Hrtf(orientation=orientation, channel=self.channel)
        raise ValueError(f"unknown capsule kind {self.kind}")


@dataclasses.dataclass
class SourceModel:
    name: str = "source"
    position: Vec3 = (0.0, 0.0, 0.0)


@dataclasses.dataclass
class ReceiverModel:
    name: str = "receiver"
    position: Vec3 = (0.0, 0.0, 0.0)
    pointing: Vec3 = (0.0, 0.0, 1.0)
    capsules: List[CapsuleModel] = dataclasses.field(
        default_factory=lambda: [CapsuleModel()])


@dataclasses.dataclass
class MaterialModel:
    name: str = "concrete"
    absorption: List[float] = dataclasses.field(
        default_factory=lambda: [0.05] * 8)
    scattering: List[float] = dataclasses.field(
        default_factory=lambda: [0.1] * 8)


@dataclasses.dataclass
class RaytracerModel:
    """Quality params (reference model/raytracer.h: quality → rays)."""

    rays: int = 1 << 16
    maximum_image_source_order: int = 4
    receiver_radius: float = 0.1
    histogram_sample_rate: float = 1000.0


@dataclasses.dataclass
class WaveguideModel:
    mode: str = "single_band"        # "single_band" | "multiple_band"
    cutoff: float = 500.0
    usable_portion: float = 0.6
    bands: int = 2                   # for multiple_band


@dataclasses.dataclass
class OutputModel:
    sample_rate: float = 44100.0
    bit_depth: str = "pcm24"
    output_directory: str = "."
    unique_id: str = ""


@dataclasses.dataclass
class Project:
    """The whole persistent state (reference model::persistent)."""

    sources: List[SourceModel] = dataclasses.field(
        default_factory=lambda: [SourceModel()])
    receivers: List[ReceiverModel] = dataclasses.field(
        default_factory=lambda: [ReceiverModel()])
    materials: List[MaterialModel] = dataclasses.field(
        default_factory=lambda: [MaterialModel()])
    raytracer: RaytracerModel = dataclasses.field(
        default_factory=RaytracerModel)
    waveguide: WaveguideModel = dataclasses.field(
        default_factory=WaveguideModel)
    output: OutputModel = dataclasses.field(default_factory=OutputModel)

    def to_dict(self) -> dict:
        # normalize tuples→lists so to_dict output is json-stable
        return json.loads(json.dumps(dataclasses.asdict(self)))

    @classmethod
    def from_dict(cls, d: dict) -> "Project":
        return cls(
            sources=[SourceModel(**s) for s in d.get("sources", [])],
            receivers=[
                ReceiverModel(
                    name=r.get("name", "receiver"),
                    position=tuple(r.get("position", (0, 0, 0))),
                    pointing=tuple(r.get("pointing", (0, 0, 1))),
                    capsules=[CapsuleModel(**c)
                              for c in r.get("capsules", [])])
                for r in d.get("receivers", [])],
            materials=[MaterialModel(**m) for m in d.get("materials", [])],
            raytracer=RaytracerModel(**d.get("raytracer", {})),
            waveguide=WaveguideModel(**d.get("waveguide", {})),
            output=OutputModel(**d.get("output", {})),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "Project":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def surface_table(self, *, device) -> Surface:
        """(S, bands) absorption + scattering tables for the engine, float32
        on ``device``."""
        def table(rows):
            return torch.tensor(rows, dtype=torch.float32, device=device)
        return Surface(
            absorption=table([m.absorption for m in self.materials]),
            scattering=table([m.scattering for m in self.materials]))


def compute_output_path(source: SourceModel, receiver: ReceiverModel,
                        capsule: CapsuleModel, output: OutputModel) -> str:
    """Reference model/output.h naming: <dir>/<id>.s_<>.r_<>.c_<>.wav"""
    base = output.unique_id or "out"
    name = f"{base}.s_{source.name}.r_{receiver.name}.c_{capsule.name}.wav"
    return f"{output.output_directory}/{name}"


# ---------------------------------------------------------------------------
# presets — absorption/scattering data after vorlander2007's tables (the
# same public dataset the reference presets draw from); a representative
# selection, not a copy of the reference's list

_S = [0.1] * 8


def _mat(name, a, s=None):
    return MaterialModel(name=name, absorption=list(a),
                         scattering=list(s or _S))


MATERIAL_PRESETS: List[MaterialModel] = [
    _mat("concrete (smooth)", [0.01, 0.01, 0.01, 0.02, 0.02, 0.02, 0.05,
                               0.05]),
    _mat("concrete (rough)", [0.02, 0.02, 0.03, 0.03, 0.03, 0.04, 0.07,
                              0.07]),
    _mat("brick (painted)", [0.01, 0.01, 0.01, 0.02, 0.02, 0.02, 0.02,
                             0.02]),
    _mat("brick (bare)", [0.03, 0.03, 0.03, 0.03, 0.04, 0.05, 0.07, 0.07]),
    _mat("marble", [0.01, 0.01, 0.01, 0.01, 0.02, 0.02, 0.02, 0.02]),
    _mat("glass (window)", [0.10, 0.10, 0.05, 0.04, 0.03, 0.03, 0.03,
                            0.03]),
    _mat("plasterboard", [0.15, 0.15, 0.10, 0.06, 0.04, 0.04, 0.05, 0.05]),
    _mat("wood panelling", [0.27, 0.27, 0.23, 0.22, 0.15, 0.10, 0.07,
                            0.06]),
    _mat("parquet floor", [0.04, 0.04, 0.04, 0.07, 0.06, 0.06, 0.07,
                           0.07]),
    _mat("carpet (thin)", [0.02, 0.04, 0.08, 0.20, 0.35, 0.40, 0.40,
                           0.40]),
    _mat("carpet (thick, on underlay)", [0.15, 0.25, 0.50, 0.60, 0.70,
                                         0.70, 0.70, 0.70]),
    _mat("curtains (heavy, draped)", [0.30, 0.45, 0.65, 0.56, 0.59, 0.71,
                                      0.71, 0.71]),
    _mat("acoustic tile", [0.50, 0.50, 0.70, 0.60, 0.70, 0.70, 0.70,
                           0.70]),
    _mat("audience on wooden chairs", [0.16, 0.24, 0.56, 0.69, 0.81, 0.78,
                                       0.75, 0.75]),
    _mat("fully absorbing", [1.0] * 8, [0.0] * 8),
    _mat("fully reflective", [0.0] * 8, [0.0] * 8),
]


CAPSULE_PRESETS: List[CapsuleModel] = [
    CapsuleModel(name="omni", kind="microphone", shape=0.0),
    CapsuleModel(name="cardioid", kind="microphone", shape=0.5),
    CapsuleModel(name="figure-of-eight", kind="microphone", shape=1.0),
    CapsuleModel(name="hrtf left", kind="hrtf", channel=0),
    CapsuleModel(name="hrtf right", kind="hrtf", channel=1),
]
