"""Dump a coding structure as a TSV and optionally emit a slurm sbatch
script whose afterok dependencies mirror the frame reference DAG (reference
CLI parity: _getcodingstruct.py).

Example:
  python -m coolchic_tpu_torch.samples.getcodingstruct --n_frames 9 \\
      --intra_pos 0 --p_pos -1 --slurm_template encode_frame.sh > gop.tsv
"""

from __future__ import annotations

import argparse
import sys

from coolchic_tpu_torch.utils.codingstructure import CodingStructure
from coolchic_tpu_torch.utils.parsecli import parse_frame_positions


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n_frames", type=int, required=True)
    p.add_argument("--intra_pos", default="0")
    p.add_argument("--p_pos", default="")
    p.add_argument("--raw_coding_struct", action="store_true",
                   help="print the raw TSV (coding_order display_order type refs depth); "
                        "it is printed either way")
    p.add_argument("--slurm_template", default="",
                   help="emit (on stderr) an sbatch script calling this template per "
                        "frame with afterok dependencies following the reference DAG")
    p.add_argument("--diagram", action="store_true", help="print the ASCII GOP diagram")
    args = p.parse_args(argv)

    cs = CodingStructure(n_frames=args.n_frames,
                         intra_pos=parse_frame_positions(args.intra_pos, args.n_frames),
                         p_pos=parse_frame_positions(args.p_pos, args.n_frames))
    if args.diagram:
        print(cs.pretty_structure_diagram())

    print("coding_order\tdisplay_order\ttype\trefs\tdepth")
    for idx in range(cs.get_max_coding_order() + 1):
        f = cs.get_frame_from_coding_order(idx)
        refs = ",".join(str(r) for r in f.index_references) or "-"
        print(f"{f.coding_order}\t{f.display_order}\t{f.frame_type}\t{refs}\t{f.depth}")

    if args.slurm_template:
        lines = ["#!/bin/bash", "# auto-generated frame-dependency DAG"]
        job_of_display = {}
        for idx in range(cs.get_max_coding_order() + 1):
            f = cs.get_frame_from_coding_order(idx)
            deps = [job_of_display[r] for r in f.index_references]
            dep_str = (f"--dependency=afterok:{':'.join('$' + d for d in deps)} "
                       if deps else "")
            var = f"JOB{f.coding_order}"
            lines.append(f"{var}=$(sbatch --parsable {dep_str}"
                         f"{args.slurm_template} {f.coding_order})")
            job_of_display[f.display_order] = var
        sys.stderr.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
