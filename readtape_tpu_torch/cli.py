"""readtape_tpu_torch command-line interface: the port of readtape_tpu/cli.py.

Same options, outputs and log as the JAX package's command line (itself
the reference readtape's surface, readtape.c:748-1022):

  python -m readtape_tpu_torch [options] <basefilename>[.csv|.tbin|.tap|.txt]

Outputs: <base>.tap or <base>.nnn.bin data files split at tapemarks / IBM
labels, <base>.log, the interpreted <base>.<opts>.txt and
<base>.peakstats.csv. The decode runs on the card; the Python entry
``main(argv, device="cpu")`` runs it on the CPU (the kernels' plain
versions), as the tests do. No path falls back to the CPU when the card is
asked for and missing: the run raises before it writes anything.

Not ported yet, and raising NotImplementedError before any file is read:
-adjskew, -correctdbg and -trace, and -mesh with more than one card
visible (with one, it is ignored, as the JAX command line does).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np

from .formats import tbin as tb
from .formats.csvfmt import read_csv
from .formats.parms import (MODE_GCR, MODE_NRZI, MODE_PE, MODE_WW,
                            load_parms)
from .formats.simh import TapWriter, read_tap
from .out.labels import describe_label, parse_label
from .out.textfile import TextFile, TxtOptions
from .version import __version__

CHARTYPES = ["ascii", "ebcdic", "bcd", "b5500", "sixbit", "sds", "sdsm",
             "flexo", "adage", "adagetape", "cdc", "univac"]
MODE_NAME = {MODE_PE: "PE", MODE_NRZI: "NRZI", MODE_GCR: "GCR",
             MODE_WW: "Whirlwind"}

USAGE = """use: python -m readtape_tpu_torch <options> <basefilename>[.ext]
  (the options of readtape_tpu and LenShustek/readtape; see README)
options include:
  -ntrks=n -order= -pe -nrzi -gcr -whirlwind -ips=n -bpi=n -zeros
  -differentiate -even -revparity=n -invert -fluxdir=d -reverse -skip=n
  -blklimit=n -subsample=n -showibg=n -tap -deskew -skew=n,n -correct
  -correct2 -parmscan -addparity -tbin -nolog -nolabels -textfile -hex
  -octal -octal2
  -ascii -ebcdic -bcd -b5500 -sixbit -sds -sdsm -flexo -adage -adagetape
  -cdc -univac -linesize=n -dataspace=n -linefeed -tapread -outf= -outp=
  -sumt= -sumc= -m -nm -v[n] -q -f
  -mesh[=DxP] (ignored with one card; more than one is not ported yet)
not ported yet: -adjskew -correctdbg -trace[=a,b]
"""


class Options:
    def __init__(self):
        self.mode = MODE_PE
        self.mode_given = False
        self.ntrks = -1
        self.order = None
        self.bpi = -1.0
        self.ips = -1.0
        self.find_zeros = False
        self.differentiate = False
        self.even = False
        self.revparity = 0
        self.invert = False
        self.fluxdir = "neg"
        self.reverse = False
        self.skip = 0
        self.blklimit = 2 ** 31 - 1
        self.subsample = 1
        self.showibg = 5000
        self.tap = False
        self.tapread = False
        self.deskew = False
        self.adjskew = False
        self.mesh = None
        self.skew = None
        self.correct = False
        self.correct2 = False
        self.correct_debug = False
        self.parmscan = False
        self.addparity = False
        self.tbin_only = False
        self.logging = True
        self.labels = True
        self.txt = False
        self.numtype = "none"
        self.chartype = "none"
        self.linesize = 0
        self.dataspace = 0
        self.linefeed = False
        self.outf = None
        self.outp = ""
        self.sumt = None
        self.sumc = None
        self.multiple_tries = True
        self.multiple_given = False
        self.verbose = False
        self.verbose_level = 0
        self.quiet = False
        self.filelist = False
        self.trace = None        # (start_secs, end_secs) or True


def parse_option(o: Options, option: str) -> bool:
    if not option.startswith("-"):
        return False
    a = option[1:].lower()

    def val(prefix):
        return a[len(prefix):] if a.startswith(prefix) else None

    if (v := val("ntrks=")) is not None:
        o.ntrks = int(v)
    elif (v := val("order=")) is not None:
        o.order = option.split("=", 1)[1]       # keep case (WW types)
    elif a == "nrzi":
        o.mode, o.mode_given = MODE_NRZI, True
    elif a == "pe":
        o.mode, o.mode_given = MODE_PE, True
    elif a == "gcr":
        o.mode, o.mode_given = MODE_GCR, True
        if o.ips < 0:
            o.ips = 25
    elif a == "whirlwind":
        o.mode, o.mode_given = MODE_WW, True
        o.bpi = 100
        if not o.multiple_given:
            o.multiple_tries = False
    elif a == "zeros":
        o.find_zeros = True
    elif a == "differentiate":
        o.differentiate = True
    elif (v := val("bpi=")) is not None:
        o.bpi = float(v)
    elif (v := val("ips=")) is not None:
        o.ips = float(v)
    elif (v := val("skip=")) is not None:
        o.skip = int(v)
    elif (v := val("blklimit=")) is not None:
        o.blklimit = int(v)
    elif (v := val("subsample=")) is not None:
        o.subsample = int(v)
    elif (v := val("showibg=")) is not None:
        o.showibg = int(v)
    elif a == "tap":
        o.tap = True
    elif a == "tapread":
        o.tapread = True
    elif a == "even":
        o.even = True
    elif (v := val("revparity=")) is not None:
        o.revparity = int(v)
    elif a == "invert":
        o.invert = True
    elif (v := val("fluxdir=")) is not None:
        assert v in ("pos", "neg", "auto"), f"bad fluxdir: {v}"
        o.fluxdir = v
    elif a == "reverse":
        o.reverse = True
    elif a == "mesh" or (v := val("mesh=")) is not None:
        # "-mesh" = all devices data-parallel, "-mesh=4x2" = (data=4,
        # parm=2), as the JAX command line parses it
        o.mesh = (1, 1) if a == "mesh" else tuple(
            int(x) for x in v.split("x"))
    elif a == "deskew":
        o.deskew = True
    elif a == "adjskew":
        o.adjskew = True        # experimental +-1 skew nudging (NRZI)
    elif (v := val("skew=")) is not None:
        o.skew = tuple(int(x) for x in v.split(","))
        o.deskew = True
    elif a == "addparity":
        o.addparity = True
    elif a == "correct":
        o.correct = True
    elif a == "correct2":     # extension: GCR 2-track erasure correction
        o.correct = True
        o.correct2 = True
    elif a == "correctdbg":
        # NRZI -correct with the reference DEBUG build's parity-check
        # index (decode_nrzi.c:258,262 under #define DEBUG true)
        o.correct = True
        o.correct_debug = True
    elif a == "nocorrect":
        o.correct = False
        o.correct2 = False
    elif a == "parmscan":     # GCR_PARMSCAN grid (a runtime option here)
        o.parmscan = True
    elif a == "tbin":
        o.tbin_only = True
    elif (v := val("outf=")) is not None:
        o.outf = option.split("=", 1)[1]
    elif (v := val("outp=")) is not None:
        o.outp = option.split("=", 1)[1]
    elif (v := val("sumt=")) is not None:
        o.sumt = option.split("=", 1)[1]
    elif (v := val("sumc=")) is not None:
        o.sumc = option.split("=", 1)[1]
    elif a == "textfile":
        o.txt = True
    elif a == "hex":
        o.numtype = "hex"
    elif a == "octal2":
        o.numtype, o.dataspace = "octal2", 2
    elif a == "octal":
        o.numtype = "octal"
    elif a in CHARTYPES:
        o.chartype = a
    elif (v := val("linesize=")) is not None:
        o.linesize = int(v)
    elif (v := val("dataspace=")) is not None:
        o.dataspace = int(v)
    elif a == "linefeed":
        o.linefeed = True
    elif (v := val("trace=")) is not None:
        parts = v.split(",")
        o.trace = (float(parts[0]), float(parts[1]) if len(parts) > 1
                   else float(parts[0]) + 0.01)
    elif a == "trace":
        o.trace = True
    elif a == "nolog":
        o.logging = False
    elif a == "nolabels":
        o.labels = False
    elif a == "nm":
        o.multiple_tries, o.multiple_given = False, True
    elif a == "m":
        o.multiple_tries, o.multiple_given = True, True
    elif a == "l":
        o.logging = True
    elif a == "q":
        o.quiet = True
        o.verbose = False
    elif a == "f":
        o.filelist = True
    elif a == "v" or (a.startswith("v") and a[1:].isdigit()):
        o.verbose = True
        o.verbose_level = int(a[1:]) if len(a) > 1 else 1
    elif a in ("h", "?"):
        print(USAGE)
        sys.exit(1)
    else:
        raise SystemExit(f"bad option: {option}\n\n{USAGE}")
    return True


class Logger:
    def __init__(self, path, quiet, summary_path=None):
        self.f = open(path, "w") if path else None
        self.quiet = quiet
        self.summary_path = summary_path
        self.sum_active = False

    def __call__(self, msg=""):
        print(msg, end="" if msg.endswith("\n") else "\n")
        if self.f:
            self.f.write(msg if msg.endswith("\n") else msg + "\n")
        if self.sum_active and self.summary_path:
            with open(self.summary_path, "a") as sf:
                sf.write(msg if msg.endswith("\n") else msg + "\n")

    def info(self, msg=""):
        if not self.quiet:
            self(msg)

    def close(self):
        if self.f:
            self.f.close()
            self.f = None


def parse_track_order(order: str, mode: int, ntrks_hint: int):
    """Non-WW -order= string like 01234567P -> head_to_trk permutation
    (readtape.c:877-919). WW strings are handled by the WW decoder."""
    n = len(order)
    head_to_trk = []
    for ch in order:
        if ch.upper() == "P":
            head_to_trk.append(n - 1)
        else:
            head_to_trk.append(int(ch))
    if sorted(head_to_trk) != list(range(n)):
        raise SystemExit(f"bad -order: {order}")
    return tuple(head_to_trk)


def run_tapread(o: Options, basefile: str, ext: str, log):
    path = basefile + (ext if ext else ".tap")
    if not os.path.exists(path) and ext:
        path = basefile + ext
    recs = read_tap(path)
    ntrks = o.ntrks if o.ntrks > 0 else 9
    topt = TxtOptions(o.numtype, o.chartype, o.linesize or 64,
                      o.dataspace, o.linefeed, verbose=False)
    outbase = o.outf or (o.outp + basefile)  # ref concatenates the
    # given path+basename verbatim (readtape.c:1972-1975), so with no
    # -outp/-outf the outputs land next to the input file
    txt = TextFile(outbase + f".{topt.suffix}txt", topt, __version__,
                   ntrks=ntrks, tapread=True)
    log(f"processing {path}\n")
    for rec in recs:
        if rec.kind == "tapemark":
            txt.tapemark()
        elif rec.kind == "gap":
            txt.message("erased gap\n")
        elif rec.kind == "eom":
            break
        else:
            txt.output_record(rec.data, 1 if rec.error else 0, 0)
    txt.close()
    log(f'created interpreted file "{txt.path}"\n')


def main(argv=None, *, device="cuda", kernel_path="fused") -> int:
    """The command line. device: where the decode runs ("cuda", the
    default, launches the kernels; "cpu" runs their plain versions);
    kernel_path: NRZI's "fused" or "tiered" kernels. Returns the exit
    code: 0, 1 when a file of a list decoded with errors, 4 on a bad
    command line."""
    argv = sys.argv[1:] if argv is None else argv
    o = Options()
    files = []
    for arg in argv:
        if arg.startswith("-") and parse_option(o, arg):
            continue
        files.append(arg)
    if len(files) != 1:
        print(USAGE, file=sys.stderr)
        return 4

    run = dict(device=device, kernel_path=kernel_path)
    cmdfile = files[0]
    base, ext = os.path.splitext(cmdfile)
    if ext.lower() not in (".tap", ".csv", ".tbin", ".txt"):
        base, ext = cmdfile, ""

    if o.filelist or ext.lower() == ".txt":
        ok = True
        with open(base + ".txt") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split()
                oo = Options()
                oo.__dict__.update(o.__dict__)
                fn = None
                for p in parts:
                    if p.startswith("-"):
                        parse_option(oo, p)
                    else:
                        fn = p
                if fn:
                    r = process_file(oo, *os.path.splitext(fn)
                                     if os.path.splitext(fn)[1].lower() in
                                     (".tap", ".csv", ".tbin") else (fn, ""),
                                     **run)
                    print(f"{fn}: {'ok' if r else 'bad'}")
                    ok = ok and r
        return 0 if ok else 1
    result = process_file(o, base, ext, **run)
    if o.quiet:
        print(f"{base}: {'ok' if result else 'bad'}")
    return 0


def process_file(o: Options, basefile: str, ext: str, *, device="cuda",
                 kernel_path="fused") -> bool:
    if not (o.tapread or ext.lower() == ".tap"):
        # before any file is read or written: no fallback from a missing
        # card, and nothing done for what the port does not run yet
        import torch

        from .decode.pipeline import check_device
        dev = check_device(device)
        cards = torch.cuda.device_count() if dev.type == "cuda" else 1
        for flag, name in ((o.trace, "-trace"), (o.adjskew, "-adjskew"),
                           (o.correct_debug, "-correctdbg"),
                           (o.mesh is not None and cards > 1, "-mesh")):
            if flag:
                raise NotImplementedError(name)
    outbase = o.outf or (o.outp + basefile)  # ref concatenates the
    # given path+basename verbatim (readtape.c:1972-1975), so with no
    # -outp/-outf the outputs land next to the input file
    log = Logger(outbase + ".log" if o.logging and not o.tapread else None,
                 o.quiet, o.sumt)
    if o.tapread or ext.lower() == ".tap":
        run_tapread(o, basefile, ext, log)
        return True

    start_time = time.time()
    log.info("readtape_tpu_torch: a PyTorch + CUDA decoder for digitized "
             "magnetic tape data")
    log.info(f"version {__version__} running on {time.ctime()}")

    # ---- ingest ----
    hdr = None
    tbin_file = None
    t0 = 0.0
    if not o.tbin_only and ext.lower() != ".tbin" and \
            os.path.exists(basefile + ".csv"):
        t0, deltat, volts = read_csv(basefile + ".csv")
        # CSV voltages stay float32 end to end (readtape.c:1405-1448);
        # maxvolts 32767 tells the decode they are volts already
        samples = np.ascontiguousarray(volts, dtype=np.float32)
        maxvolts = 32767.0
        ntrks = volts.shape[1]
        log.info(f'reading file "{basefile}.csv"')
    else:
        path = basefile + ".tbin"
        if not os.path.exists(path):
            raise SystemExit(f"no input file {basefile}(.csv/.tbin)")
        hdr, samples = tb.read_tbin(path)
        tbin_file = path
        deltat = hdr.tdelta_ns * 1e-9
        maxvolts = hdr.maxvolts
        ntrks = hdr.ntrks
        t0 = hdr.tstart_ns * 1e-9
        log.info(f'reading file "{path}"')
        log.info("\n.tbin file header:")
        if hdr.mode != tb.MODE_UNKNOWN and not o.mode_given:
            o.mode = hdr.mode
            log.info(f"  using .tbin mode = {MODE_NAME.get(o.mode, '?')}")
        if o.bpi < 0 and hdr.bpi:
            o.bpi = hdr.bpi
            log.info(f"  using .tbin bpi = {hdr.bpi:.0f}")
        if o.ips < 0 and hdr.ips:
            o.ips = hdr.ips
            log.info(f"  using .tbin ips = {hdr.ips:.0f}")
        if o.ntrks <= 0:
            o.ntrks = ntrks
        if hdr.trkorder and o.order is None:
            o.order = hdr.trkorder
        if hdr.descr:
            log.info(f"   description: {hdr.descr}")
        log.info(f"  max voltage: {maxvolts:.1f}V")
        log.info(f"  time between samples: {hdr.tdelta_ns/1000:.3f} usec")

    if o.ntrks <= 0:
        o.ntrks = ntrks
    if o.subsample > 1:
        samples = samples[o.subsample - 1::o.subsample]
        deltat *= o.subsample
    if o.skip:
        samples = samples[o.skip:]
        t0 += o.skip * deltat

    # ---- parms ----
    parmsets = load_parms(basefile, o.mode)
    for extra in parmsets.extra_options:
        parse_option(o, extra)
    for w in parmsets.warnings:
        log.info(f"  --->{w}")
    if parmsets.source != "builtin":
        log.info(f"\nreading parmsets from file {parmsets.source}")
    else:
        log.info(f"\nno .parms file was found, so we're using internal "
                 f"defaults for the {MODE_NAME[o.mode]} parameter sets:")
    log.info(parmsets.describe())

    if o.ips < 0:
        o.ips = 50.0
    if o.find_zeros and o.mode not in (MODE_NRZI, MODE_GCR):
        # PE/Whirlwind zero-crossing decodes need the per-track clock
        # coupling that only the GCR/NRZI paths implement
        raise SystemExit(f"-zeros is not supported for {MODE_NAME[o.mode]} "
                         "(only NRZI and GCR)")
    if o.mode == MODE_GCR:
        if o.bpi != 9042:
            log.info("BPI was reset to 9042 for GCR 6250")
        o.bpi = 9042
    head_to_trk = None
    if o.order and o.mode != MODE_WW:
        if tbin_file and hdr and not (hdr.flags & tb.TBIN_NO_REORDER):
            log.info("  -order was ignored because the track ordering was "
                     "changed to canonical when the .tbin file was created")
        else:
            head_to_trk = parse_track_order(o.order, o.mode, o.ntrks)
            if o.ntrks <= 0:
                o.ntrks = len(head_to_trk)

    if o.mesh is not None:
        log.info("  -mesh ignored: only one device visible")

    from .decode.pipeline import DecodeOptions, TapeDecoder, decode_tape
    dopts = DecodeOptions(
        mode=o.mode, ntrks=o.ntrks, bpi=max(o.bpi, 0), ips=o.ips,
        deltat=deltat, maxvolts=maxvolts, parmsets=parmsets,
        multiple_tries=o.multiple_tries, do_correct=o.correct,
        do_correct2=o.correct2, do_correct_debug=o.correct_debug,
        parmscan=o.parmscan,
        expected_parity=0 if o.even else 1, revparity=o.revparity,
        invert=o.invert, differentiate=o.differentiate,
        find_zeros=o.find_zeros, deskew=o.deskew, skew=o.skew,
        adjskew=o.adjskew,
        add_parity=o.addparity, head_to_trk=head_to_trk,
        reverse=o.reverse, fluxdir=o.fluxdir,
        ww_order=o.order or "CMLcml", blklimit=o.blklimit, t0_seconds=t0)

    dec = None
    if o.bpi <= 0:
        # the tape uploads once: detection and decode share the decoder
        dec = TapeDecoder(samples, dopts, device=dev,
                          kernel_path=kernel_path)
        std, raw = dec.detect_density(dec.segments())
        dec.opts = dopts = dataclasses.replace(dopts, bpi=std)
        log.info(f"  density was set to {std:.0f} BPI (detected "
                 f"{raw:.0f} BPI)")

    log.info("\nexecution-time configuration:")
    log.info(f"  {o.ntrks} track {MODE_NAME[o.mode]} encoding, "
             f"{'no' if o.mode == MODE_WW else 'even' if o.even else 'odd'} "
             f"parity, {dopts.bpi:.0f} BPI at {o.ips:.0f} IPS "
             f"({1e6/(dopts.bpi*o.ips):.2f} usec/bit)")
    log.info(f"  sampling rate is {1.0/deltat:,.0f} Hz "
             f"({deltat*1e6:.2f} usec), or about "
             f"{dopts.spb:.0f} samples per bit")

    # ---- decode ----
    blocks, stats = decode_tape(samples, dopts, log, device=dev,
                                decoder=dec, kernel_path=kernel_path)

    # ---- outputs ----
    write_outputs(o, outbase, blocks, stats, dopts, log, start_time,
                  len(samples), t0=t0, deltat=deltat, hdr=hdr)
    log.close()
    return stats["nerrblocks"] == 0 and stats["nunusable"] == 0


def write_outputs(o, outbase, blocks, stats, dopts, log, start_time,
                  nsamples, t0=0.0, deltat=1.0, hdr=None):
    txt = None
    if o.txt or o.numtype != "none" or o.chartype != "none":
        topt = TxtOptions(o.numtype, o.chartype, o.linesize,
                          o.dataspace, o.linefeed, verbose=True)
        txt = TextFile(outbase + f".{topt.suffix}txt", topt, __version__,
                       ntrks=o.ntrks)
        log.info(f'creating file "{txt.path}"')

    tapw = None
    binf = None
    numfiles = 0
    numfilebytes = 0
    numblks = 0
    numoutbytes = 0
    hdr1_active = False
    prev_end = None

    def open_bin(name=None):
        nonlocal binf, numfiles, numfilebytes
        close_bin()
        numfiles += 1
        path = (name + ".bin") if name else f"{outbase}.{numfiles:03d}.bin"
        log.info(f'creating file "{path}"')
        binf = open(path, "wb")
        numfilebytes = 0

    def close_bin():
        nonlocal binf
        if binf:
            binf.close()
            binf = None

    if o.tap:
        tapw = TapWriter(outbase + ".tap")
        log.info(f'creating file "{outbase}.tap"')

    for blk in blocks:
        # interblock-gap reporting (readtape.c:1148-1158)
        if prev_end is not None and blk.t_start > prev_end:
            ibg_ms = int((blk.t_start - prev_end) * 1000 + 0.5)
            if o.showibg == 0 or ibg_ms >= o.showibg:
                msg = f"{ibg_ms // 1000}.{ibg_ms % 1000:03d} sec interblock gap!"
                log(msg)
                if txt:
                    txt.message(msg + "\n")
        prev_end = blk.t_end if blk.t_end else prev_end
        if blk.kind == "tapemark":
            log.info(f"  tapemark at time {blk.t_start:.8f}, "
                     f"{numblks} blocks written so far")
            if txt:
                txt.tapemark(blk.t_start)
            if tapw:
                tapw.write_tapemark()
            elif not hdr1_active:
                close_bin()
            hdr1_active = False
            continue
        if blk.kind == "badblock":
            log(f"ERROR: unusable block, tracks mismatched with lengths "
                f"{blk.detail.get('minbits')} to {blk.detail.get('maxbits')},"
                f" {blk.tries} tries, parmset {blk.parmset}, "
                f"at time {blk.t_end:.8f}")
            continue
        if len(blk.data) == 0:
            # zero-length decodes are dropped entirely (readtape.c:1217
            # guards on length > 0; a 0-length .tap record would read back
            # as a tapemark)
            continue
        # data block: IBM labels are logged always, absorbed (not written)
        # unless in .tap mode (readtape.c:1216-1217; ibmlabels.c:147-153)
        labeled = False
        if o.labels:
            info = parse_label(blk.data)
            if info:
                log.info(describe_label(info, blk.errcount))
                if not tapw:
                    if info.kind == "HDR1":
                        name = (f"{outbase}-{numfiles+1:03d}-"
                                f"{info.dataset_filename}")
                        open_bin(name.rstrip())
                        hdr1_active = True
                    if info.kind == "EOF1":
                        close_bin()
                labeled = True
        if not labeled or tapw:
            if tapw:
                tapw.write_block(blk.data, error=blk.errcount > 0)
                numoutbytes += len(blk.data)
            else:
                if binf is None:
                    open_bin()
                binf.write(blk.data)
                numfilebytes += len(blk.data)
                numoutbytes += len(blk.data)
            if txt:
                errinfo = format_block_errors(blk)
                txt.output_record(blk.data, blk.errcount, blk.warncount,
                                  blocknum=numblks + 1, timenow=blk.t_end,
                                  errinfo=errinfo)
            numblks += 1
            if o.verbose or numblks == 1 or (
                    not o.quiet and (blk.errcount or blk.warncount)):
                ag = blk.detail.get("alltrk_min_agc", 0)
                ag2 = blk.detail.get("alltrk_max_agc", 0)
                # min gain left at its FLT_MAX init means AGC never
                # adjusted (e.g. -zeros); the C then shows only the max
                # (readtape.c:1285-1287)
                agc_txt = (f"max AGC {ag2:.2f}" if ag >= 1e38
                           else f"AGC {ag:.2f}-{ag2:.2f}")
                sp = blk.detail.get("avg_bit_spacing", 0) * dopts.deltat
                speed = 1.0 / (sp * dopts.bpi) if sp > 0 else 0.0
                log(f"wrote block {numblks:3d}, {len(blk.data):4d} bytes, "
                    f"{blk.tries} {'tries' if blk.tries > 1 else 'try'}, "
                    f"parmset {blk.parmset}, {agc_txt}, "
                    f"{format_block_errors(blk)}, avg speed {speed:.2f} IPS "
                    f"at time {blk.t_end:.8f}")
            # -adjskew per-track report (adjust_deskew, decoder.c:306-320);
            # the port does not run -adjskew yet, so no block carries one
            for trk, (dev, bsp, act, newskew) in enumerate(
                    blk.detail.get("adjskew", [])):
                line = (f"trk {trk} deviation is {dev * 1e6:.2f} usec of "
                        f"bitspacing {bsp * 1e6:.2f} usec")
                if act < 0:
                    line += f", skew reduced to {newskew}"
                elif act > 0:
                    line += f", skew increased to {newskew}"
                log(line)

    if tapw:
        tapw.write_eom()
        tapw.close()
    close_bin()
    if txt:
        txt.close()

    # peak-timing statistics CSV (decoder.c:175-214)
    if stats.get("peak_trksums") is not None and \
            np.sum(stats["peak_trksums"]) > 0:
        from .out.peakstats import write_peakstats
        lb, bw = stats["peak_bins"]
        total = write_peakstats(outbase + ".peakstats.csv",
                                stats["peak_hist"], stats["peak_trksums"],
                                lb, bw, dopts.mode == MODE_NRZI)
        log.info(f'  created statistics file "{outbase}.peakstats.csv" from '
                 f'{total:,} measurements of flux transition positions')

    elapsed = time.time() - start_time
    # tape-data extent: first output's time to the end of sampling
    # (readtape.c:2028: timenow - data_start_time)
    data_blocks = [b for b in blocks if b.kind == "data" and len(b.data)]
    tape_end = t0 + nsamples * deltat
    data_start = data_blocks[0].t_end if data_blocks else tape_end
    data_secs = max(tape_end - data_start, 0.0)
    last_block_time = data_blocks[-1].t_end if data_blocks else 0.0
    log.info("")
    log.sum_active = True
    log.info(f'summary for file "{outbase}":')
    log.info(f"  {nsamples:,} samples were processed in {elapsed:.0f} "
             f"seconds ({0 if numblks == 0 else elapsed/numblks:.3f} "
             f"seconds/block)")
    log.info(f"  created {numfiles} output file"
             f"{'s' if numfiles != 1 else ''} with a total of "
             f"{numoutbytes:,} bytes")
    log.info(f"  decoded {stats['ntapemarks']} tape marks and "
             f"{numblks} blocks with {numoutbytes:,} bytes from "
             f"{data_secs:.2f} seconds of tape data")
    if last_block_time:
        log.info(f"  the last block written was {last_block_time:.8f} "
                 "seconds into the tape")
    line = (f"  {stats['nerrblocks']} block"
            f"{'s' if stats['nerrblocks'] != 1 else ''} had errors, "
            f"{stats['nwarnblocks']} had warnings")
    if dopts.mode != MODE_WW:
        line += (f", {stats['nmismatched']} had mismatched tracks, "
                 f"{stats['ncorrected']} had bits corrected")
    if dopts.mode == MODE_NRZI:
        line += f", {stats['nmidbiterr']} had midbit timing errors"
    log.info(line)
    if dopts.mode == MODE_WW and stats.get("num_flux_changes", 0) > 0:
        n = stats["num_flux_changes"]
        log.info(f"  the flux polarity changed {n} time"
                 f"{'s' if n > 1 else ''} during decoding")
    if stats["nunusable"]:
        log.info(f"  {stats['nunusable']} blocks were unusable and were "
                 "not written")
    log.sum_active = False
    if o.multiple_tries:
        log.info(f"  {stats['ngoodmultiple']} good blocks had to try more "
                 "than one parmset")
        for i, (t, c) in enumerate(zip(stats["tried"], stats["chosen"])):
            if t > 0:
                log.info(f"  parmset {i} was tried {t:4d} times and used "
                         f"{c:4d} times, or {100.0*c/t:5.1f}%")
    # head-skew report (skew_compute_deskew(false), decoder.c:243-283)
    skew_ok = True
    if stats.get("peak_trksums") is not None and \
            np.asarray(stats["peak_trksums"]).min() > 0:
        skew_ok = report_skew(stats, dopts, o, log)
    if o.sumc:
        with open(o.sumc, "a") as f:
            inverted = "yes" if (hdr is not None and
                                 hdr.flags & tb.TBIN_INVERTED) else ""
            if dopts.mode == MODE_WW:
                fluxdir = ("pos&neg" if stats.get("num_flux_changes", 0)
                           else stats.get("flux_dir_final", "neg"))
            else:
                fluxdir = ""
            order_str = o.order or ""
            f.write(f'="{outbase}",="{inverted}",="{fluxdir}",'
                    f'="{order_str}", {data_secs:.2f}, '
                    f'{stats["ntapemarks"]}, '
                    f'{numblks}, {numoutbytes}, '
                    f'{stats["nerrblocks"]}, {stats["nwarnblocks"]}, '
                    f'{stats.get("num_flux_changes", 0)},'
                    f'"{"y" if skew_ok else "n"}"\n')


def report_skew(stats, dopts, o, log) -> bool:
    """skew_compute_deskew(false) at end of run (decoder.c:243-283): peak
    position average/std-dev per track from the peakstats histogram, with
    the reference's warning thresholds."""
    hist = np.asarray(stats["peak_hist"], np.float64)       # [T, 50]
    sums = np.asarray(stats["peak_trksums"], np.float64)
    lb, bw = stats["peak_bins"]
    us = bw * 1e6 * np.arange(50) + lb * 1e6
    interior = slice(1, 49)
    avg = (hist[:, interior] * us[interior]).sum(axis=1) / np.maximum(sums, 1)
    dev = us[interior][None, :] - avg[:, None]
    stddev = np.sqrt((hist[:, interior] * dev * dev).sum(axis=1) /
                     np.maximum(sums, 1))
    maxavg, minavg = avg.max(), avg.min()
    bitspace_us = 1e6 / (dopts.bpi * dopts.ips)
    peak_frac = (maxavg - minavg) / bitspace_us
    stddev_frac = stddev.max() / bitspace_us
    if not o.quiet:
        log.info(f"  the earliest peak is {minavg:.2f} usec, and the "
                 f"latest peak is {maxavg:.2f} usec")
        log.info(f"  that peak difference of {maxavg-minavg:.2f} usec, and "
                 f"the largest standard deviation of {stddev.max():.2f} "
                 f"usec, are {peak_frac*100:.1f}% and {stddev_frac*100:.1f}%"
                 f" of the nominal bit spacing")
    # DESKEW_PEAKDIFF_WARNING / DESKEW_STDDEV_WARNING (decoder.h:44-45)
    skew_ok = peak_frac < 0.20 and stddev_frac < 0.05
    log.sum_active = True
    if skew_ok:
        if o.deskew:
            log.info(f"  deskewing with delays up to "
                     f"{stats['deskew_percent']:.1f}% of a bit time seems "
                     "to have been successful")
        else:
            log.info("  the tape data head skew is minimal")
    else:
        if o.deskew:
            log.info(f"  deskewing with delays up to "
                     f"{stats['deskew_percent']:.1f}% of a bit time wasn't "
                     "entirely effective")
            log.info("  the tape might have been written by two different "
                     "drives")
            log.info("  if so you should consider separating the data into "
                     "those sections")
        else:
            log.info("  head skew is significant; you should try again "
                     "with the -deskew option")
    log.sum_active = False
    return skew_ok


def format_block_errors(blk) -> str:
    d = blk.detail
    parts = []
    if blk.errcount > 0:
        s = f"{blk.errcount} err{'s' if blk.errcount > 1 else ''}"
        if d.get("track_mismatch"):
            s += f", {d['track_mismatch']} bit track mismatch"
        if d.get("vparity_errs"):
            s += f", {d['vparity_errs']} parity"
        if d.get("crc_errs"):
            s += f", {d['crc_errs']} CRC"
        if d.get("lrc_errs"):
            s += ", 1 LRC"
        if d.get("ecc_errs"):
            s += f", {d['ecc_errs']} ECC"
        parts.append(s)
    else:
        parts.append("ok")
    if blk.warncount > 0:
        s = f"{blk.warncount} warning{'s' if blk.warncount > 1 else ''}"
        if d.get("corrected_bits"):
            s += f", {d['corrected_bits']} corrected bits"
        if d.get("gcr_bad_dgroups"):
            s += f", {d['gcr_bad_dgroups']} bad dgroups"
        parts.append(s)
    return ", ".join(parts)


if __name__ == "__main__":
    sys.exit(main())
