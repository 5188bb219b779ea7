"""VTM-style layered cfg-file parser (`Key : value`, later files win).

Role of VTM:Utilities/program_options_lite.{h,cpp} + EncAppCfg.cpp: option
names match the VTM cfg vocabulary where the tool exists here, so CTC-style
cfg files port directly (SURVEY.md §5 "same option names where they exist").
CLI flags override cfg values.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class AppConfig:
    width: int = 0                # SourceWidth
    height: int = 0               # SourceHeight
    frames: int | None = None     # FramesToBeEncoded
    qp: int = 32                  # QP
    intra_period: int = 1         # IntraPeriod (-1 -> 0: first frame only)
    gop: int = 1                  # GOPSize
    bit_depth: int = 8            # InputBitDepth
    wpp: bool = False             # EntropyCodingSyncEnabled / WaveFrontSynchro
    sao: bool = True              # SAO
    mts: bool = False             # MTS / MTSIntra
    lfnst: bool = False           # LFNST
    cclm: bool = False            # LMChroma / CCLM
    mip: bool = False             # MIP
    mrl: bool = False             # MRL
    tskip: bool = False           # TransformSkip / TSM
    jccr: bool = False            # JointCbCr
    mmvd: bool = False            # MMVD
    dmvr: bool = False            # DMVR
    bcw: bool = False             # BCW / GBi
    amvr: bool = False            # AMVR / IMV
    smvd: bool = False            # SMVD
    ciip: bool = False            # CIIP
    sbt: bool = False             # SBT
    isp: bool = False             # ISP
    gpm: bool = False             # Geo / GPM
    affine: bool = False          # Affine
    bdof: bool = False            # BIO / BDOF
    rdoq: bool = True             # RDOQ
    dq: bool = False              # DepQuant (4-state trellis)
    mtt: bool = False             # MTT binary splits
    tt: bool = False              # MTT ternary splits (32 nodes)
    ibc: bool = False             # IBC (intra block copy)
    plt: bool = False             # PLT (palette mode)
    tile_cols: int = 1
    tile_rows: int = 1
    lmcs: bool = False            # LMCSEnable / LMCS
    alf: bool = False             # ALF
    mctf: bool = False            # TemporalFilter / MCTF
    rate_control: bool = False    # RateControl
    target_bitrate: int = 0       # TargetBitrate (bits/s)
    frame_rate: int = 30          # FrameRate
    deblock: bool = True          # (inverse of) LoopFilterDisable
    hash_type: int = 0            # DecodedPictureHashSEI (1 MD5/2 CRC/3 sum)
    input_file: str = ""          # InputFile
    bitstream_file: str = ""      # BitstreamFile
    recon_file: str = ""          # ReconFile


_KEYMAP = {
    "sourcewidth": ("width", int),
    "sourceheight": ("height", int),
    "framestobeencoded": ("frames", int),
    "qp": ("qp", int),
    "intraperiod": ("intra_period", lambda v: 0 if int(v) < 0 else int(v)),
    "gopsize": ("gop", int),
    "inputbitdepth": ("bit_depth", int),
    "entropycodingsyncenabled": ("wpp", lambda v: bool(int(v))),
    "wavefrontsynchro": ("wpp", lambda v: bool(int(v))),
    "sao": ("sao", lambda v: bool(int(v))),
    "mts": ("mts", lambda v: bool(int(v))),
    "mtsintra": ("mts", lambda v: bool(int(v))),
    "lfnst": ("lfnst", lambda v: bool(int(v))),
    "cclm": ("cclm", lambda v: bool(int(v))),
    "lmchroma": ("cclm", lambda v: bool(int(v))),
    "mip": ("mip", lambda v: bool(int(v))),
    "mrl": ("mrl", lambda v: bool(int(v))),
    "transformskip": ("tskip", lambda v: bool(int(v))),
    "tsm": ("tskip", lambda v: bool(int(v))),
    "jointcbcr": ("jccr", lambda v: bool(int(v))),
    "mmvd": ("mmvd", lambda v: bool(int(v))),
    "dmvr": ("dmvr", lambda v: bool(int(v))),
    "bcw": ("bcw", lambda v: bool(int(v))),
    "gbi": ("bcw", lambda v: bool(int(v))),
    "amvr": ("amvr", lambda v: bool(int(v))),
    "imv": ("amvr", lambda v: bool(int(v))),
    "smvd": ("smvd", lambda v: bool(int(v))),
    "ciip": ("ciip", lambda v: bool(int(v))),
    "isp": ("isp", lambda v: bool(int(v))),
    "geo": ("gpm", lambda v: bool(int(v))),
    "gpm": ("gpm", lambda v: bool(int(v))),
    "affine": ("affine", lambda v: bool(int(v))),
    "sbt": ("sbt", lambda v: bool(int(v))),
    "bio": ("bdof", lambda v: bool(int(v))),
    "bdof": ("bdof", lambda v: bool(int(v))),
    "rdoq": ("rdoq", lambda v: bool(int(v))),
    "depquant": ("dq", lambda v: bool(int(v))),
    "mtt": ("mtt", lambda v: bool(int(v))),
    "tt": ("tt", lambda v: bool(int(v))),
    "maxmtthierarchydepth": ("mtt", lambda v: int(v) > 0),
    "ibc": ("ibc", lambda v: bool(int(v))),
    "plt": ("plt", lambda v: bool(int(v))),
    "palettemode": ("plt", lambda v: bool(int(v))),
    "tilecolumns": ("tile_cols", int),
    "tilerows": ("tile_rows", int),
    "lmcs": ("lmcs", lambda v: bool(int(v))),
    "lmcsenable": ("lmcs", lambda v: bool(int(v))),
    "alf": ("alf", lambda v: bool(int(v))),
    "temporalfilter": ("mctf", lambda v: bool(int(v))),
    "mctf": ("mctf", lambda v: bool(int(v))),
    "ratecontrol": ("rate_control", lambda v: bool(int(v))),
    "targetbitrate": ("target_bitrate", int),
    "framerate": ("frame_rate", lambda v: int(float(v))),
    "loopfilterdisable": ("deblock", lambda v: not bool(int(v))),
    "decodedpicturehashsei": ("hash_type",
                              lambda v: max(0, min(2, int(v) - 1))),
    "inputfile": ("input_file", str),
    "bitstreamfile": ("bitstream_file", str),
    "reconfile": ("recon_file", str),
}


def parse_cfg_file(path: str, cfg: AppConfig | None = None) -> AppConfig:
    cfg = cfg or AppConfig()
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.split("#")[0].split("//")[0].strip()
            if not line:
                continue
            if ":" not in line:
                raise ValueError(f"{path}:{ln}: expected 'Key : value'")
            key, _, val = line.partition(":")
            key = key.strip().lower()
            val = val.strip()
            if key in _KEYMAP:
                attr, conv = _KEYMAP[key]
                setattr(cfg, attr, conv(val))
            # unknown keys are ignored (forward compatibility, like the
            # reference tolerates unknown per-sequence options)
    return cfg


def load_layered(paths: list[str]) -> AppConfig:
    cfg = AppConfig()
    for p in paths:
        cfg = parse_cfg_file(p, cfg)
    return cfg


def rc_bits_per_frame(cfg: AppConfig) -> int:
    """Per-frame bit budget from VTM-style RateControl/TargetBitrate keys."""
    if cfg.rate_control and cfg.target_bitrate > 0:
        return max(1, cfg.target_bitrate // max(cfg.frame_rate, 1))
    return 0
