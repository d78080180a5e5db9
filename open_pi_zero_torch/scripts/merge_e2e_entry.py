"""Merge a demonstration's output JSON (``demo_closed_loop``,
``demo_qlora_finetune``, ``e2e_tier_sweep``, ``eval_scaleup_ckpt``) into
one of the repo's evidence files under a named key, keeping everything
else (counterpart of the JAX package's ``scripts/merge_e2e_entry.py``,
the same command line and the same bytes written).

  python -m open_pi_zero_torch.scripts.merge_e2e_entry \\
      --src build/pick_place.json --dst E2E_CLOSED_LOOP_TORCH.json \\
      --key pick_place [--extra k=v ...]

Without ``--key`` the entry replaces the whole file (the layout of
``E2E_QLORA_TORCH.json``). ``--extra k=v`` adds string fields to the entry.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--key", default=None, help="entry key in dst (omit = replace dst root, the "
                                                "E2E_QLORA_TORCH.json layout)")
    ap.add_argument("--extra", nargs="*", default=[], help="extra k=v string fields to annotate the entry")
    args = ap.parse_args(argv)

    with open(args.src) as f:
        entry = json.load(f)
    for kv in args.extra:
        k, v = kv.split("=", 1)
        entry[k] = v

    if args.key is None:
        merged = entry
    else:
        try:
            with open(args.dst) as f:
                merged = json.load(f)
        except FileNotFoundError:
            merged = {}
        merged[args.key] = entry

    with open(args.dst, "w") as f:
        json.dump(merged, f, indent=1)
    print(f"merged {args.src} -> {args.dst}" + (f"[{args.key}]" if args.key else ""))


if __name__ == "__main__":
    main()
