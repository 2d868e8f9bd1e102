#!/usr/bin/env python
"""``audio-separator-torch-remote`` CLI — submit jobs to a remote separation
API (ref: audio_separator/remote/cli.py:13-348); the port's own copy of
``audio_separator_tpu/remote/cli.py``. Server URL from --api_url or the
AUDIO_SEPARATOR_API_URL env var."""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Remote audio separation client.",
        formatter_class=lambda prog: argparse.RawTextHelpFormatter(prog, max_help_position=50))
    parser.add_argument("--api_key", default=None,
                        help="API key for a keyed server (or AUDSEP_API_KEY env var).")
    parser.add_argument("--api_url",
                        default=os.environ.get("AUDIO_SEPARATOR_API_URL"),
                        help="Remote API URL (or AUDIO_SEPARATOR_API_URL env var).")
    parser.add_argument("--log_level", default="info")

    sub = parser.add_subparsers(dest="command")

    sep = sub.add_parser("separate", help="Separate audio file(s) remotely")
    sep.add_argument("audio_files", nargs="+")
    sep.add_argument("-m", "--model", default=None)
    sep.add_argument("--models", nargs="+", default=None)
    sep.add_argument("--preset", default=None)
    sep.add_argument("--output_format", default="flac")
    sep.add_argument("--output_dir", default=None)
    sep.add_argument("--output_single_stem", "--single_stem", dest="output_single_stem",
                     default=None)
    sep.add_argument("--sample_rate", type=int, default=None)
    sep.add_argument("--use_soundfile", action="store_true")
    sep.add_argument("--use_autocast", action="store_true")
    sep.add_argument("--custom_output_names", type=json.loads, default=None)
    sep.add_argument("--timeout", type=int, default=600)
    sep.add_argument("--poll_interval", type=float, default=2.0)
    sep.add_argument("--no_download", action="store_true")
    sep.add_argument("--debug", action="store_true")
    # Separator tuning params forwarded as form fields
    # (ref: remote/cli.py + api_client.py:30-169)
    sep.add_argument("--invert_spect", action="store_true")
    sep.add_argument("--normalization", type=float, default=None)
    sep.add_argument("--amplification", type=float, default=None)
    sep.add_argument("--output_bitrate", default=None)
    sep.add_argument("--mdx_segment_size", type=int, default=None)
    sep.add_argument("--mdx_overlap", type=float, default=None)
    sep.add_argument("--mdx_batch_size", type=int, default=None)
    sep.add_argument("--mdx_hop_length", type=int, default=None)
    sep.add_argument("--mdx_enable_denoise", action="store_true")
    sep.add_argument("--vr_batch_size", type=int, default=None)
    sep.add_argument("--vr_window_size", type=int, default=None)
    sep.add_argument("--vr_aggression", type=int, default=None)
    sep.add_argument("--vr_enable_tta", action="store_true")
    sep.add_argument("--vr_high_end_process", action="store_true")
    sep.add_argument("--vr_enable_post_process", action="store_true")
    sep.add_argument("--vr_post_process_threshold", type=float, default=None)
    sep.add_argument("--demucs_segment_size", default=None)
    sep.add_argument("--demucs_shifts", type=int, default=None)
    sep.add_argument("--demucs_overlap", type=float, default=None)
    sep.add_argument("--demucs_segments_enabled", default=None)
    sep.add_argument("--mdxc_segment_size", type=int, default=None)
    sep.add_argument("--mdxc_override_model_segment_size", action="store_true")
    sep.add_argument("--mdxc_overlap", type=int, default=None)
    sep.add_argument("--mdxc_batch_size", type=int, default=None)
    sep.add_argument("--mdxc_pitch_shift", type=int, default=None)

    status = sub.add_parser("status", help="Check job status")
    status.add_argument("task_id")

    models_p = sub.add_parser("models", help="List models on the server")
    models_p.add_argument("--format", choices=["pretty", "json"], default="pretty")
    models_p.add_argument("--filter", dest="filter_by", default=None)

    download = sub.add_parser("download", help="Download output files for a job")
    download.add_argument("task_id")
    download.add_argument("filenames", nargs="*",
                          help="Specific files (default: all in job status)")
    download.add_argument("--output_dir", default=None)

    sub.add_parser("version", help="Show server version")

    args = parser.parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level.upper()))

    if not args.command:
        parser.print_help()
        sys.exit(1)
    if not args.api_url:
        print("Error: --api_url or AUDIO_SEPARATOR_API_URL required", file=sys.stderr)
        sys.exit(1)

    from .api_client import AudioSeparatorAPIClient

    client = AudioSeparatorAPIClient(args.api_url, api_key=args.api_key)

    if args.command == "separate":
        tuning_keys = [
            "sample_rate", "use_soundfile", "use_autocast",
            "invert_spect", "normalization", "amplification", "output_bitrate",
            "mdx_segment_size", "mdx_overlap", "mdx_batch_size",
            "mdx_hop_length", "mdx_enable_denoise",
            "vr_batch_size", "vr_window_size", "vr_aggression", "vr_enable_tta",
            "vr_high_end_process", "vr_enable_post_process",
            "vr_post_process_threshold",
            "demucs_segment_size", "demucs_shifts", "demucs_overlap",
            "demucs_segments_enabled",
            "mdxc_segment_size", "mdxc_override_model_segment_size",
            "mdxc_overlap", "mdxc_batch_size", "mdxc_pitch_shift",
        ]
        # Identity checks: `0 == False` in Python, so a membership test
        # against (None, False) would silently drop explicit zero values
        # (--vr_aggression 0, --demucs_shifts 0, ...).
        tuning = {k: getattr(args, k) for k in tuning_keys
                  if getattr(args, k) is not None
                  and getattr(args, k) is not False}
        # client-kwarg names differ for these three (match the Separator API)
        if tuning.pop("invert_spect", None):
            tuning["invert_using_spec"] = True
        if "normalization" in tuning:
            tuning["normalization_threshold"] = tuning.pop("normalization")
        if "amplification" in tuning:
            tuning["amplification_threshold"] = tuning.pop("amplification")
        for path in args.audio_files:
            result = client.separate_audio_and_wait(
                file_path=path,
                model=args.model,
                models=args.models,
                preset=args.preset,
                output_format=args.output_format,
                output_single_stem=args.output_single_stem,
                custom_output_names=args.custom_output_names,
                download=not args.no_download,
                output_dir=args.output_dir,
                timeout=args.timeout,
                poll_interval=args.poll_interval,
                **tuning,
            )
            print(json.dumps({
                "task_id": result["task_id"],
                "files": result["status"].get("files", []),
                "downloaded": result["downloaded_files"],
            }, indent=2))
    elif args.command == "status":
        print(json.dumps(client.get_job_status(args.task_id), indent=2))
    elif args.command == "models":
        models = client.list_models(format_type=args.format, filter_by=args.filter_by)
        if args.format == "json":
            print(json.dumps(models, indent=2))
        else:
            for filename, info in models.items():
                stems = ", ".join(info.get("Stems", [])) if isinstance(info, dict) else ""
                name = info.get("Name", "") if isinstance(info, dict) else ""
                print(f"{filename:<55} {stems:<30} {name}")
    elif args.command == "download":
        status_data = client.get_job_status(args.task_id)
        wanted = set(args.filenames) if args.filenames else None
        for entry in status_data.get("files", []):
            if wanted and entry["filename"] not in wanted:
                continue
            path = client.download_file_by_hash(
                args.task_id, entry["hash"], entry["filename"], args.output_dir)
            print(path)
    elif args.command == "version":
        print(client.get_server_version())


if __name__ == "__main__":
    main()
