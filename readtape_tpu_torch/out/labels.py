"""IBM standard tape labels (VOL1/HDR1/HDR2/EOF1/EOF2/EOV1/EOV2).

Detects 80-byte label blocks, extracts their fields for the log, names output
files from the HDR1 dataset identifier, and suppresses label blocks from the
data output (ibmlabels.c:118-168; readtape.c:1216).

The port's own copy of readtape_tpu/out/labels.py: the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

from .charsets import EBCDIC


def _ebc(data: bytes) -> str:
    return "".join(chr(EBCDIC[b]) for b in data)


@dataclass
class LabelInfo:
    kind: str              # VOL1 | HDR1 | HDR2 | EOF1 | EOF2 | EOV1 | EOV2
    fields: dict
    dataset_filename: str = None     # for HDR1: suggested output file name


def parse_label(data: bytes) -> LabelInfo | None:
    """Return label info if this 80-byte block is an IBM standard label."""
    if len(data) != 80:
        return None
    text = _ebc(data)
    kind = text[:4]
    if kind == "VOL1":
        return LabelInfo("VOL1", dict(
            serno=text[4:10].rstrip(), owner=text[41:51].rstrip()))
    if kind in ("HDR1", "EOF1", "EOV1"):
        fields = dict(
            dsid=text[4:21].rstrip(), serno=text[21:27].rstrip(),
            volseqno=text[27:31].rstrip(), dsseqno=text[31:35].rstrip(),
            created=text[41:47].rstrip(), blkcnt=text[54:60].rstrip(),
            syscode=text[60:73].rstrip())
        info = LabelInfo(kind, fields)
        if kind == "HDR1":
            info.dataset_filename = fields["dsid"]
        return info
    if kind in ("HDR2", "EOF2", "EOV2"):
        return LabelInfo(kind, dict(
            recfm=text[4:5], blklen=text[5:10].rstrip(),
            reclen=text[10:15].rstrip(), density=text[15:16],
            job=text[17:34].rstrip(), blkattrib=text[38:39]))
    return None


def describe_label(info: LabelInfo, errcount: int = 0) -> str:
    f = info.fields
    if info.kind == "VOL1":
        s = (f'*** tape label VOL1, serno "{f["serno"]}", '
             f'owner "{f["owner"]}"')
    elif info.kind in ("HDR1", "EOF1", "EOV1"):
        s = (f'*** tape label {info.kind}, dsid "{f["dsid"]}", '
             f'serno "{f["serno"]}", created{f["created"]}\n'
             f'    volume {f["volseqno"]}, dataset {f["dsseqno"]}')
        if info.kind == "EOF1":
            s += f'\n    block count {f["blkcnt"]}, system {f["syscode"]}'
    else:
        s = (f'*** tape label {info.kind}, RECFM={f["recfm"]}{f["blkattrib"]},'
             f' BLKSIZE={f["blklen"]}, LRECL={f["reclen"]}\n'
             f'    job: "{f["job"]}"')
    if errcount:
        s += f"\n--> {errcount} errors"
    return s
