"""avifenc-equivalent CLI (reference: apps/avifenc.c, 2714 LoC).

Flag surface mirrors the reference's core options: quality/qalpha, speed,
depth, yuv format, range, CICP, lossless, grid, animation timing,
metadata injection, transforms. Run `python -m libavif_tpu.cli.avifenc -h`.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from ..constants import VERSION

    p = argparse.ArgumentParser(
        prog="avifenc", description="Encode images to AVIF (TPU-native codec)"
    )
    p.add_argument("-V", "--version", action="version", version=f"avifenc (libavif_tpu) {VERSION}")
    p.add_argument(
        "inputs", nargs="+",
        help="input file(s): png/jpeg/y4m, or '-' for stdin (test_cmd_stdin.sh parity)",
    )
    p.add_argument("output", help="output.avif")
    p.add_argument("-q", "--qcolor", type=int, default=60, help="color quality 0-100")
    p.add_argument("--qalpha", type=int, default=-1, help="alpha quality 0-100")
    p.add_argument("-s", "--speed", type=int, default=6, help="encoder speed 0-10")
    p.add_argument("-l", "--lossless", action="store_true", help="lossless (q=100)")
    p.add_argument("-d", "--depth", type=int, choices=(8, 10, 12), help="coding depth")
    p.add_argument(
        "-y", "--yuv", choices=("444", "422", "420", "400"), help="YUV format"
    )
    p.add_argument("-r", "--range", choices=("limited", "full"), default="full")
    p.add_argument("--cicp", "--nclx", dest="cicp", help="P/T/M, e.g. 1/13/6")
    p.add_argument("-g", "--grid", help="MxN grid split of a single input")
    p.add_argument("--fps", type=float, default=30.0, help="animation frame rate")
    p.add_argument("--timescale", type=int, help="animation timescale (overrides fps)")
    p.add_argument("--duration", type=int, default=1, help="frame duration (timescales)")
    p.add_argument("-k", "--keyframe", type=int, default=0, help="keyframe interval")
    p.add_argument("--exif", help="Exif payload file to inject")
    p.add_argument("--xmp", help="XMP payload file to inject")
    p.add_argument("--icc", help="ICC profile file to inject")
    p.add_argument("--irot", type=int, choices=(0, 1, 2, 3), help="rotation (90° ccw units)")
    p.add_argument("--imir", type=int, choices=(0, 1), help="mirror axis")
    p.add_argument("--pasp", help="pixel aspect ratio: Hspacing,Vspacing")
    p.add_argument("--clap", help="clean aperture: WN,WD,HN,HD,HON,HOD,VON,VOD")
    p.add_argument("--clli", help="content light level: MaxCLL,MaxPALL")
    p.add_argument("--tx-size", type=int, default=16, choices=(4, 8, 16, 32))
    p.add_argument(
        "-a", "--advanced", action="append", default=[], metavar="KEY=VALUE",
        help="codec-specific option (avifenc -a; e.g. -a enable-cdef=0, "
        "-a cq-level=32, -a mode-breadth=5, -a color:tx-breadth=2)",
    )
    p.add_argument("--tilerowslog2", type=int, default=0, help="log2 tile rows 0-6 (manual tiling)")
    p.add_argument("--tilecolslog2", type=int, default=0, help="log2 tile cols 0-6 (manual tiling)")
    p.add_argument("--autotiling", action="store_true", help="pick the tile grid automatically")
    p.add_argument(
        "-c", "--codec", choices=("auto", "spec", "native"), default="auto",
        help="auto/spec: spec-conformant AV1 (decodes in any AVIF "
        "viewer; the default); native: the TPU-pipelined own format "
        "(fastest, decodes only with this framework)",
    )
    p.add_argument(
        "--sharpyuv", action="store_true",
        help="sharp RGB->YUV420 chroma downsampling",
    )
    p.add_argument(
        "--target-size", type=int,
        help="search the quality that fits this many bytes (stills only)",
    )
    p.add_argument(
        "--progressive", metavar="Q1,Q2,...",
        help="layered progressive encode at these qualities (stills only)",
    )
    return p


def _target_size_search(image, args, proto_encoder):
    """Bisect quality to fit --target-size (reference: avifenc.c
    --target-size search loop)."""
    from ..api.encoder import Encoder

    lo, hi = 0, 100
    best = None
    while lo <= hi:
        q = (lo + hi) // 2
        enc = Encoder()
        enc.quality = q
        enc.quality_alpha = proto_encoder.quality_alpha
        enc.speed = proto_encoder.speed
        enc.tx_size = proto_encoder.tx_size
        enc.codec_choice = proto_encoder.codec_choice
        data = enc.write(image)
        if len(data) <= args.target_size:
            best = data
            lo = q + 1  # best quality that still fits
        else:
            hi = q - 1
    if best is None:
        # Even quality 0 exceeds the budget: return the smallest encode.
        enc = Encoder()
        enc.quality = 0
        enc.speed = proto_encoder.speed
        enc.codec_choice = proto_encoder.codec_choice
        best = enc.write(image)
    return best


# Options that accept the avifenc `:u` / `:update` suffix (reference
# apps/avifenc.c:278-328, parseOptionSuffix): suffixed occurrences apply
# only to input files appearing after them; unsuffixed ones apply to all
# inputs (with a warning when that is ambiguous). --duration always
# behaves as if suffixed. Values are the option arities.
_UPDATABLE = {
    "-q": 1, "--qcolor": 1, "--qalpha": 1, "--duration": 1,
    "-a": 1, "--advanced": 1,
    "--tilerowslog2": 1, "--tilecolslog2": 1, "--autotiling": 0,
}


def _split_updatable(argv, parser):
    """Pre-parse `:u`-suffixed options out of argv.

    Returns (cleaned_argv_for_argparse, per_input) where per_input[i] is
    the {flag: value(s)} snapshot in effect for the i-th positional
    (inputs AND the trailing output; the caller drops the last one)."""
    arity = {}
    for action in parser._actions:
        for opt in action.option_strings:
            arity[opt] = 0 if action.nargs == 0 else 1
    opts = []
    positionals = []
    events = []  # ("set", flag, value) | ("pos",)
    seen_input = False
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok.startswith("-") and len(tok) > 1 and not tok[1].isdigit():
            base, suffixed = tok, False
            if ":" in tok and "=" not in tok.split(":", 1)[0]:
                head, suf = tok.split(":", 1)
                if suf in ("u", "update") and head in _UPDATABLE:
                    base, suffixed = head, True
                elif suf in ("u", "update"):
                    raise SystemExit(f"ERROR: {head} does not accept the :{suf} suffix")
            if base in _UPDATABLE:
                n = _UPDATABLE[base]
                val = argv[i + 1] if n else True
                if suffixed or base == "--duration":
                    events.append(("set", base, val))
                else:
                    if seen_input:
                        print(
                            f"WARNING: {base} is applying to all inputs. Use "
                            f"{base}:u to apply only to inputs after it, or "
                            "move it before the first input to avoid ambiguity.",
                            file=sys.stderr,
                        )
                    opts.extend(argv[i : i + 1 + n])
                i += 1 + n
                continue
            # non-updatable option: copy it plus its value tokens
            key = base.split("=", 1)[0]
            n = 0 if "=" in base else arity.get(key, 0)
            opts.extend(argv[i : i + 1 + n])
            i += 1 + n
            continue
        # positional (input or output)
        positionals.append(tok)
        events.append(("pos",))
        seen_input = True
        i += 1
    # argparse can't take positionals interleaved with options when
    # `inputs` is nargs='+'; ordering semantics live in `events`.
    cleaned = opts + positionals
    per_input = []
    pending = {}
    for ev in events:
        if ev[0] == "pos":
            per_input.append({k: (list(v) if isinstance(v, list) else v)
                              for k, v in pending.items()})
        else:
            _, flag, val = ev
            if flag in ("-a", "--advanced"):
                pending.setdefault("-a", []).append(val)
            elif flag in ("-q", "--qcolor"):
                pending["-q"] = val
            else:
                pending[flag] = val
    return cleaned, per_input


def _parse_fraction_list(arg, count, flag):
    vals = [int(x) for x in arg.split(",")]
    if len(vals) != count:
        raise SystemExit(f"{flag} expects {count} comma-separated integers")
    return vals


def main(argv=None) -> int:
    parser = build_parser()
    raw = list(argv) if argv is not None else sys.argv[1:]
    cleaned, per_pos = _split_updatable(raw, parser)
    args = parser.parse_args(cleaned)
    # per_pos covers every positional; the last one is the output path
    per_input = per_pos[:-1] if len(per_pos) == len(args.inputs) + 1 else [
        {} for _ in args.inputs
    ]

    if "-" in args.inputs:
        # Materialize stdin once so format sniffing and multi-pass reads work.
        import tempfile

        raw = sys.stdin.buffer.read()
        tmp = tempfile.NamedTemporaryFile(suffix=".stdin", delete=False)
        tmp.write(raw)
        tmp.close()
        args.inputs = [tmp.name if p == "-" else p for p in args.inputs]

    from ..api.encoder import Encoder
    from ..constants import PixelFormat, Range, TransformFlags
    from ..image import (
        CleanApertureBox,
        ContentLightLevelInformationBox,
        ImageMirror,
        ImageRotation,
        PixelAspectRatioBox,
    )
    from ..io_formats import read_image
    from ..io_formats.y4m import count_y4m_frames
    from ..io_formats import guess_format

    fmt_map = {
        "444": PixelFormat.YUV444,
        "422": PixelFormat.YUV422,
        "420": PixelFormat.YUV420,
        "400": PixelFormat.YUV400,
    }
    req_fmt = fmt_map[args.yuv] if args.yuv else None

    quality = 100 if args.lossless else args.qcolor
    lossless_identity = False
    if args.lossless and not args.yuv:
        # true RGB-lossless requires 4:4:4 + identity matrix + full range
        # (reference avifenc -l behavior, apps/avifenc.c lossless checks)
        req_fmt = PixelFormat.YUV444
        lossless_identity = True
        if not args.cicp:
            args.cicp = "1/13/0"  # sRGB primaries/transfer, identity matrix

    def load(path):
        from ..constants import MatrixCoefficients

        img = read_image(
            path, requested_format=req_fmt, requested_depth=args.depth,
            sharp_yuv=args.sharpyuv,
            matrix_coefficients=(
                MatrixCoefficients.IDENTITY if lossless_identity else None
            ),
        )
        if args.range == "limited":
            img.yuv_range = Range.LIMITED
        if args.cicp:
            parts = args.cicp.split("/")
            if len(parts) != 3:
                raise SystemExit("--cicp expects P/T/M")
            img.color_primaries = int(parts[0])
            img.transfer_characteristics = int(parts[1])
            img.matrix_coefficients = int(parts[2])
        if args.icc:
            img.icc = pathlib.Path(args.icc).read_bytes()
        if args.exif:
            img.exif = pathlib.Path(args.exif).read_bytes()
        if args.xmp:
            img.xmp = pathlib.Path(args.xmp).read_bytes()
        if args.irot is not None:
            img.irot = ImageRotation(angle=args.irot)
            img.transform_flags |= TransformFlags.IROT
        if args.imir is not None:
            img.imir = ImageMirror(axis=args.imir)
            img.transform_flags |= TransformFlags.IMIR
        if args.pasp:
            h, v = _parse_fraction_list(args.pasp, 2, "--pasp")
            img.pasp = PixelAspectRatioBox(h_spacing=h, v_spacing=v)
            img.transform_flags |= TransformFlags.PASP
        if args.clap:
            v = _parse_fraction_list(args.clap, 8, "--clap")
            img.clap = CleanApertureBox(*v)
            img.transform_flags |= TransformFlags.CLAP
        if args.clli:
            cll, pall = _parse_fraction_list(args.clli, 2, "--clli")
            img.clli = ContentLightLevelInformationBox(max_cll=cll, max_pall=pall)
        return img

    enc = Encoder()
    enc.quality = quality
    enc.quality_alpha = 100 if args.lossless else args.qalpha
    enc.speed = args.speed
    enc.keyframe_interval = args.keyframe
    enc.tx_size = args.tx_size
    enc.codec_choice = args.codec
    enc.tile_rows_log2 = args.tilerowslog2
    enc.tile_cols_log2 = args.tilecolslog2
    if args.autotiling:
        enc.auto_tiling = True
    for kv in args.advanced:
        if "=" not in kv:
            print(f"bad -a option (need KEY=VALUE): {kv}", file=sys.stderr)
            return 1
        k, v = kv.split("=", 1)
        enc.set_codec_specific_option(k.strip(), v.strip())

    def apply_updates(upd) -> int:
        """Apply one input's `:u` settings snapshot; returns its frame
        duration (reference: avifInputFileSettings application)."""
        if "-q" in upd:
            enc.quality = 100 if args.lossless else int(upd["-q"])
        if "--qalpha" in upd:
            enc.quality_alpha = int(upd["--qalpha"])
        if "--tilerowslog2" in upd:
            enc.tile_rows_log2 = int(upd["--tilerowslog2"])
        if "--tilecolslog2" in upd:
            enc.tile_cols_log2 = int(upd["--tilecolslog2"])
        if "--autotiling" in upd:
            enc.auto_tiling = True
        for kv in upd.get("-a", []):
            if "=" not in kv:
                raise SystemExit(f"bad -a option (need KEY=VALUE): {kv}")
            k, v = kv.split("=", 1)
            enc.set_codec_specific_option(k.strip(), v.strip())
        return int(upd.get("--duration", args.duration))

    if args.grid:
        try:
            cols, rows = (int(x) for x in args.grid.lower().split("x"))
        except ValueError:
            raise SystemExit("-g/--grid expects MxN")
        if len(args.inputs) != 1:
            raise SystemExit("grid mode takes exactly one input")
        apply_updates(per_input[0])
        img = load(args.inputs[0])
        cells = []
        cw = -(-img.width // cols)
        ch = -(-img.height // rows)
        # MIAF: cells on non-final edges must be equal size; split evenly.
        from ..image import CropRect

        for r in range(rows):
            for c in range(cols):
                w = min(cw, img.width - c * cw)
                h = min(ch, img.height - r * ch)
                cells.append(img.view_rect(CropRect(c * cw, r * ch, w, h)))
        data = enc.write_grid(cells, columns=cols, rows=rows)
    else:
        # Animation when multiple inputs or a multi-frame y4m.
        frames = []  # (image, per-input settings, duration)
        for idx, path in enumerate(args.inputs):
            upd = per_input[idx] if idx < len(per_input) else {}
            duration = int(upd.get("--duration", args.duration))
            if guess_format(path) == "y4m":
                n = count_y4m_frames(path)
                from ..io_formats.y4m import read_y4m

                for i in range(n):
                    frames.append((read_y4m(path, i), upd, duration))
            else:
                frames.append((load(path), upd, duration))
        if len(frames) == 1 and args.progressive:
            apply_updates(frames[0][1])
            qualities = [int(q) for q in args.progressive.split(",")]
            data = enc.write_progressive(frames[0][0], qualities)
        elif len(frames) == 1 and args.target_size:
            apply_updates(frames[0][1])
            data = _target_size_search(frames[0][0], args, enc)
        elif len(frames) == 1:
            apply_updates(frames[0][1])
            data = enc.write(frames[0][0])
        else:
            enc.timescale = args.timescale or int(round(args.fps))
            for f, upd, duration in frames:
                apply_updates(upd)  # settings captured per frame at add
                enc.add_image(f, duration=duration)
            data = enc.finish()

    pathlib.Path(args.output).write_bytes(data)
    print(f"Wrote {args.output}: {len(data)} bytes", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
