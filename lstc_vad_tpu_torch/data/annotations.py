"""Annotation file parsers — one per reference txt format (SURVEY §2.7).

A copy of lstc_vad_tpu/data/annotations.py (text parsing only).

Formats (as in the reference's data/*):
- SHT train  (SH_Train_new.txt):   "key,label"            label 0/1
  (utils/load_dataset.py:37-39)
- SHT test   (SH_Test_NEW.txt):    "key,label,n_frames"   n_frames -1 for
  abnormal videos (the GT mask supplies the length) (utils/load_dataset.py:115-126)
- UCF train  (Train_Annotation.txt): "path/video.mp4 n_frames" space-separated;
  class from the "Normal_" name prefix (utils/load_dataset.py:393-399)
- UCF test   (Test_Annotation.txt): "path n_frames class s1 e1 s2 e2"
  (utils/load_dataset.py:481-489)
- UBnormal   (train/test_video_names_frames.txt): "key,n_frames"; class from
  the "normal_"/"abnormal_" prefix (utils/load_dataset.py:540-542,613-617)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TrainRecord:
    key: str
    is_abnormal: bool
    n_frames: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class SHTestRecord:
    key: str
    is_abnormal: bool
    n_frames: int  # -1 for abnormal (mask file supplies the length)


def _lines(txt_path: str) -> List[str]:
    with open(txt_path, "r") as f:
        return [ln.strip() for ln in f if ln.strip()]


def parse_sht_train(txt_path: str) -> List[TrainRecord]:
    out = []
    for line in _lines(txt_path):
        parts = line.split(",")
        # the reference buckets label==0 as normal and EVERYTHING else as
        # abnormal (utils/load_dataset.py:41-46), not just label==1
        out.append(TrainRecord(key=parts[0], is_abnormal=int(parts[-1]) != 0))
    return out


def parse_sht_test(txt_path: str) -> List[SHTestRecord]:
    out = []
    for line in _lines(txt_path):
        parts = line.split(",")
        out.append(SHTestRecord(key=parts[0], is_abnormal=parts[1] == "1",
                                n_frames=int(parts[-1])))
    return out


def _ucf_key(path_field: str) -> str:
    return path_field.split("/")[-1].split(".")[0]


def parse_ucf_train(txt_path: str) -> List[TrainRecord]:
    out = []
    for line in _lines(txt_path):
        fields = line.split(" ")
        key = _ucf_key(fields[0])
        out.append(TrainRecord(key=key, n_frames=int(fields[1]),
                               is_abnormal=key.split("_")[0] != "Normal"))
    return out


@dataclasses.dataclass(frozen=True)
class UCFTestRecord:
    key: str
    n_frames: int
    class_name: str
    events: Tuple[Tuple[int, int], ...]  # (start, end) frame pairs, -1 padded

    @property
    def is_abnormal(self) -> bool:
        return self.class_name != "Normal"


def parse_ucf_test(txt_path: str) -> List[UCFTestRecord]:
    out = []
    for line in _lines(txt_path):
        fields = line.split()
        # the reference indexes path as split('/')[1] (load_dataset.py:469);
        # use the basename, which is equivalent for the shipped 'Class/video.mp4'
        key = _ucf_key(fields[0])
        n_frames = int(fields[1])
        class_name = fields[2]
        bounds = [int(v) for v in fields[3:]]
        events = tuple((bounds[i], bounds[i + 1])
                       for i in range(0, len(bounds) - 1, 2)
                       if bounds[i] >= 0)
        out.append(UCFTestRecord(key, n_frames, class_name, events))
    return out


def parse_ubnormal(txt_path: str) -> List[TrainRecord]:
    out = []
    for line in _lines(txt_path):
        parts = line.split(",")
        key = parts[0]
        n_frames = int(parts[1]) if len(parts) > 1 else None
        out.append(TrainRecord(key=key, n_frames=n_frames,
                               is_abnormal=key.split("_")[0] != "normal"))
    return out
