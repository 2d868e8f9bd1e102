#!/usr/bin/env python
"""``audio-separator-torch`` CLI: the flags and ``main(argv)`` flow of
``audio_separator_tpu/utils/cli.py`` over the port's ``Separator``.

    python -m audio_separator_tpu_torch.utils.cli mix.wav [--device cpu] ...

Differences from the JAX package's CLI:

* ``--device`` (default: the CUDA device) is passed to ``Separator``; without a
  card the default raises, and ``--device cpu`` runs the plain PyTorch path;
* ``--output_format`` defaults to FLAC, as in the JAX package; FLAC and the
  other non-WAV formats need the native codec (``io/audio.py``), so where
  libav is missing pass ``--output_format WAV``;
* ``--env_info`` prints the torch, CUDA and card facts;
* ``--list_models``, ``--list_presets`` and ``--download_model_only`` honour
  ``--model_file_dir``;
* ``--use_mesh`` spreads each window batch over every local CUDA device
  (a data-parallel mesh, ``parallel/mesh.py``); with one card, or with
  ``--device cpu``, it takes the plain path.

Ensembles: ``-m A --extra_models B ...`` (with ``--ensemble_algorithm`` and
``--ensemble_weights``), or ``--ensemble_preset NAME`` (``--list_presets``
lists them).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from ..separator.separator import DEFAULT_MODEL


def _build_parser(version: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Separate audio file into different stems (PyTorch; CUDA by default).",
        formatter_class=lambda prog: argparse.RawTextHelpFormatter(prog, max_help_position=60),
    )
    parser.add_argument("audio_files", nargs="*", default=argparse.SUPPRESS,
                        help="The audio file paths or directory to separate.")

    info = parser.add_argument_group("Info and Debugging")
    info.add_argument("-v", "--version", action="version", version=f"%(prog)s {version}")
    info.add_argument("-d", "--debug", action="store_true",
                      help="Enable debug logging, equivalent to --log_level=debug.")
    info.add_argument("-e", "--env_info", action="store_true",
                      help="Print environment information and exit.")
    info.add_argument("-l", "--list_models", action="store_true",
                      help="List all supported models and exit.")
    info.add_argument("--log_level", default="info", help="Log level, e.g. info, debug, warning.")
    info.add_argument("--list_filter",
                      help="Filter/sort the model list by 'name', 'filename', or a stem name.")
    info.add_argument("--list_limit", type=int, help="Limit the number of models shown.")
    info.add_argument("--list_format", choices=["pretty", "json"], default="pretty",
                      help="Model list output format.")
    info.add_argument("--device", default=None,
                      help="Torch device to compute on: cuda (the default) or cpu.")

    io = parser.add_argument_group("Separation I/O Params")
    io.add_argument("-m", "--model_filename", default=DEFAULT_MODEL,
                    help="Model to use for separation.")
    io.add_argument("--extra_models", nargs="+", default=None,
                    help="Additional models for ensembling.")
    io.add_argument("--output_format", default="FLAC",
                    help="Output format for separated files (non-WAV formats need the "
                         "native codec).")
    io.add_argument("--output_bitrate", default=None, help="Output bitrate, e.g. 320k.")
    io.add_argument("--output_dir", default=None, help="Directory to write output files.")
    io.add_argument("--model_file_dir", default=None,
                    help="Model files directory (default: /tmp/audio-separator-models/ or "
                         "AUDIO_SEPARATOR_MODEL_DIR).")
    io.add_argument("--download_model_only", action="store_true",
                    help="Download a single model file only, without performing separation.")

    common = parser.add_argument_group("Common Separation Parameters")
    common.add_argument("--invert_spect", action="store_true",
                        help="Invert secondary stem using spectrogram.")
    common.add_argument("--normalization", type=float, default=0.9,
                        help="Max peak amplitude to normalize input and output audio to.")
    common.add_argument("--amplification", type=float, default=0.0,
                        help="Min peak amplitude to amplify input and output audio to.")
    common.add_argument("--single_stem", default=None,
                        help="Output only single stem, e.g. Instrumental, Vocals.")
    common.add_argument("--sample_rate", type=int, default=44100,
                        help="Sample rate of the output audio.")
    common.add_argument("--use_soundfile", action="store_true",
                        help="Use (compat flag) direct file writing for output.")
    common.add_argument("--use_autocast", action="store_true",
                        help="Use bfloat16 mixed precision for faster inference.")
    common.add_argument("--chunk_duration", type=float, default=None,
                        help="Split audio into chunks of this many seconds for processing.")
    common.add_argument("--use_mesh", action="store_true",
                        help="Split demix window batches across all local CUDA devices "
                             "(data-parallel device mesh).")
    common.add_argument("--trace_dir", default=None,
                        help="Write a torch.profiler Chrome trace of each separation "
                             "into this directory.")
    common.add_argument("--ensemble_algorithm", default=None,
                        choices=["avg_wave", "median_wave", "min_wave", "max_wave",
                                 "avg_fft", "median_fft", "min_fft", "max_fft",
                                 "uvr_max_spec", "uvr_min_spec", "ensemble_wav"],
                        help="Algorithm for ensembling multiple models.")
    common.add_argument("--ensemble_weights", nargs="+", type=float, default=None,
                        help="Weights for ensembling multiple models.")
    common.add_argument("--ensemble_preset", default=None,
                        help="Use a named ensemble preset (see --list_presets).")
    common.add_argument("--list_presets", action="store_true",
                        help="List all available ensemble presets and exit.")
    common.add_argument("--custom_output_names", type=json.loads, default=None,
                        help='Custom names for output files in JSON format, e.g. '
                             '\'{"Vocals": "vocals_out"}\'.')

    mdx = parser.add_argument_group("MDX Architecture Parameters")
    mdx.add_argument("--mdx_segment_size", type=int, default=256)
    mdx.add_argument("--mdx_overlap", type=float, default=0.25)
    mdx.add_argument("--mdx_batch_size", type=int, default=4)
    mdx.add_argument("--mdx_hop_length", type=int, default=1024)
    mdx.add_argument("--mdx_enable_denoise", action="store_true")

    vr = parser.add_argument_group("VR Architecture Parameters")
    vr.add_argument("--vr_batch_size", type=int, default=4)
    vr.add_argument("--vr_window_size", type=int, default=512)
    vr.add_argument("--vr_aggression", type=int, default=5)
    vr.add_argument("--vr_enable_tta", action="store_true")
    vr.add_argument("--vr_high_end_process", action="store_true")
    vr.add_argument("--vr_enable_post_process", action="store_true")
    vr.add_argument("--vr_post_process_threshold", type=float, default=0.2)

    demucs = parser.add_argument_group("Demucs Architecture Parameters")
    demucs.add_argument("--demucs_segment_size", type=str, default="Default")
    demucs.add_argument("--demucs_shifts", type=int, default=2)
    demucs.add_argument("--demucs_overlap", type=float, default=0.25)
    demucs.add_argument("--demucs_segments_enabled", default="True",
                        help="Enable segment-wise processing (True/False).")

    mdxc = parser.add_argument_group("MDXC Architecture Parameters")
    mdxc.add_argument("--mdxc_segment_size", type=int, default=256)
    mdxc.add_argument("--mdxc_override_model_segment_size", action="store_true")
    mdxc.add_argument("--mdxc_overlap", type=int, default=8)
    mdxc.add_argument("--mdxc_batch_size", type=int, default=4)
    mdxc.add_argument("--mdxc_pitch_shift", type=int, default=0)
    return parser


def _print_model_table(models: dict) -> None:
    if not models:
        print("No models available.")
        return
    fn_w = max(len("Model Filename"), max(len(f) for f in models))
    arch_w = max(len("Arch"), max(len(i["Type"]) for i in models.values()))
    stems_w = max(len("Output Stems (SDR)"), max(len(", ".join(i["Stems"])) for i in models.values()))
    total = fn_w + arch_w + stems_w + max(len(i["Name"]) for i in models.values()) + 15
    print("-" * total)
    print(f"{'Model Filename':<{fn_w}}  {'Arch':<{arch_w}}  {'Output Stems (SDR)':<{stems_w}}  Friendly Name")
    print("-" * total)
    for filename, inf in models.items():
        print(f"{filename:<{fn_w}}  {inf['Type']:<{arch_w}}  {', '.join(inf['Stems']):<{stems_w}}  {inf['Name']}")


def _print_preset_table(presets: dict) -> None:
    if not presets:
        print("No ensemble presets available.")
        return
    id_w = max(len("Preset ID"), max(len(k) for k in presets))
    desc_w = max(len("Description"),
                 max(len(p.get("description", "")[:60]) for p in presets.values()))
    print("-" * (id_w + desc_w + 22))
    print(f"{'Preset ID':<{id_w}}  {'Description':<{desc_w}}  Models  Algorithm")
    print("-" * (id_w + desc_w + 22))
    for pid, preset in presets.items():
        print(f"{pid:<{id_w}}  {preset.get('description', '')[:60]:<{desc_w}}  "
              f"{len(preset.get('models', [])):<6}  {preset.get('algorithm', '')}")


def _print_env_info(device) -> None:
    import platform

    import torch

    print(f"Python {platform.python_version()} on {platform.system()} {platform.release()}")
    print(f"torch {torch.__version__}, built for CUDA {torch.version.cuda}, "
          f"cuDNN {torch.backends.cudnn.version()}")
    print(f"CUDA available: {torch.cuda.is_available()}, devices: {torch.cuda.device_count()}")
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        print(f"  cuda:{i} {props.name}, compute capability {props.major}.{props.minor}, "
              f"{props.total_memory / 2 ** 30:.1f} GiB")
    print(f"Separator device: {device or 'cuda'}")


def main(argv=None):
    from .. import __version__

    logger = logging.getLogger(__name__)
    formatter = logging.Formatter(
        fmt="%(asctime)s.%(msecs)03d - %(levelname)s - %(module)s - %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")
    if not logger.hasHandlers():  # main() may be called repeatedly in-process
        handler = logging.StreamHandler()
        handler.setFormatter(formatter)
        logger.addHandler(handler)

    parser = _build_parser(__version__)
    args = parser.parse_args(argv)

    log_level = logging.DEBUG if args.debug else getattr(logging, args.log_level.upper())
    logger.setLevel(log_level)

    from ..separator import Separator

    if args.env_info:
        _print_env_info(args.device)
        Separator(log_formatter=formatter, log_level=log_level, device=args.device)
        sys.exit(0)

    if args.list_models:
        separator = Separator(info_only=True, model_file_dir=args.model_file_dir)
        if args.list_format == "json":
            print(json.dumps(separator.list_supported_model_files(), indent=2))
        else:
            models = separator.get_simplified_model_list(filter_sort_by=args.list_filter)
            if args.list_limit and args.list_limit > 0:
                models = dict(list(models.items())[: args.list_limit])
            _print_model_table(models)
        sys.exit(0)

    if args.list_presets:
        separator = Separator(info_only=True, model_file_dir=args.model_file_dir)
        _print_preset_table(separator.list_ensemble_presets())
        sys.exit(0)

    if args.download_model_only:
        separator = Separator(log_formatter=formatter, log_level=log_level,
                              model_file_dir=args.model_file_dir, info_only=True)
        for model in [args.model_filename] + (args.extra_models or []):
            separator.download_model_and_data(model)
        sys.exit(0)

    audio_files = list(getattr(args, "audio_files", []))
    if not audio_files:
        parser.print_help()
        sys.exit(1)

    separator = Separator(
        log_formatter=formatter,
        log_level=log_level,
        model_file_dir=args.model_file_dir,
        output_dir=args.output_dir,
        output_format=args.output_format,
        output_bitrate=args.output_bitrate,
        normalization_threshold=args.normalization,
        amplification_threshold=args.amplification,
        output_single_stem=args.single_stem,
        invert_using_spec=args.invert_spect,
        sample_rate=args.sample_rate,
        use_soundfile=args.use_soundfile,
        use_autocast=args.use_autocast,
        chunk_duration=args.chunk_duration,
        use_mesh=args.use_mesh,
        trace_dir=args.trace_dir,
        ensemble_algorithm=args.ensemble_algorithm,
        ensemble_weights=args.ensemble_weights,
        ensemble_preset=args.ensemble_preset,
        mdx_params={
            "hop_length": args.mdx_hop_length,
            "segment_size": args.mdx_segment_size,
            "overlap": args.mdx_overlap,
            "batch_size": args.mdx_batch_size,
            "enable_denoise": args.mdx_enable_denoise,
        },
        vr_params={
            "batch_size": args.vr_batch_size,
            "window_size": args.vr_window_size,
            "aggression": args.vr_aggression,
            "enable_tta": args.vr_enable_tta,
            "enable_post_process": args.vr_enable_post_process,
            "post_process_threshold": args.vr_post_process_threshold,
            "high_end_process": args.vr_high_end_process,
        },
        demucs_params={
            "segment_size": args.demucs_segment_size,
            "shifts": args.demucs_shifts,
            "overlap": args.demucs_overlap,
            "segments_enabled": str(args.demucs_segments_enabled).lower()
            not in ("false", "0", "no", "off"),
        },
        mdxc_params={
            "segment_size": args.mdxc_segment_size,
            "batch_size": args.mdxc_batch_size,
            "overlap": args.mdxc_overlap,
            "override_model_segment_size": args.mdxc_override_model_segment_size,
            "pitch_shift": args.mdxc_pitch_shift,
        },
        device=args.device,
    )
    if args.ensemble_preset and args.model_filename == DEFAULT_MODEL and not args.extra_models:
        separator.load_model()  # the preset's models
    else:
        model_filenames = [args.model_filename] + (args.extra_models or [])
        separator.load_model(
            model_filename=model_filenames if len(model_filenames) > 1 else model_filenames[0])
    output_files = separator.separate(audio_files, custom_output_names=args.custom_output_names)
    logger.info(f"Separation complete! Output file(s): {' '.join(output_files)}")


if __name__ == "__main__":
    main()
