"""Compare the build's ptxas report with the commit before the backward's
input-gradient pass (c) became two kernels (csrc/field_grad.cu
input_sm90_kernel and input_chain_kernel).

    python -m posegen_tpu_torch.tools.ptxas_vs_parent

Builds the kernels (or loads the cached build) on a machine with nvcc and
prints, for every kernel that change left alone (kernel 4's passes (a),
(b) and its reduce, the small reductions, the variants; and the eval
kernel's four modes, found by the start of their mangled names), its
registers and spill bytes beside the ones that commit's build reported for
sm_90a. Exits 1 if one differs. A record of that change: a later edit of
one of these kernels, or another nvcc, changes the report with no fault in
the port.
"""

from __future__ import annotations

import sys

from posegen_tpu_torch.kernels import build

# (registers, spill store bytes, spill load bytes) of the parent's build
PARENT = {
    "_ZN7posegen14ray_sum_kernelEPKfiiPf": (30, 0, 0),
    "_ZN7posegen16vbias_sum_kernelEPKfiPf": (30, 0, 0),
    "_ZN7posegen17vbias_part_kernelEPKfiiiPf": (31, 0, 0),
    "_ZN7posegen17wgrad_sm90_kernelENS_9WgradJobsE": (154, 0, 0),
    "_ZN7posegen18bias_reduce_kernelEPKfiNS_6LayoutEPf": (32, 0, 0),
    "_ZN7posegen18pose_reduce_kernelEPKfiiiPfi": (30, 0, 0),
    "_ZN7posegen19wgrad_reduce_kernelENS_9WgradJobsE": (31, 0, 0),
    "_ZN7posegen20field_variant_kernelILi128ELb0EEEvPKfS2_iS2_iiNS_6LayoutEPK13__nv_bfloat16S2_iiiPf": (253, 0, 0),
    "_ZN7posegen20field_variant_kernelILi128ELb1EEEvPKfS2_iS2_iiNS_6LayoutEPK13__nv_bfloat16S2_iiiPf": (254, 0, 0),
    "_ZN7posegen20field_variant_kernelILi32ELb0EEEvPKfS2_iS2_iiNS_6LayoutEPK13__nv_bfloat16S2_iiiPf": (110, 0, 0),
    "_ZN7posegen20field_variant_kernelILi32ELb1EEEvPKfS2_iS2_iiNS_6LayoutEPK13__nv_bfloat16S2_iiiPf": (110, 0, 0),
    "_ZN7posegen20field_variant_kernelILi64ELb0EEEvPKfS2_iS2_iiNS_6LayoutEPK13__nv_bfloat16S2_iiiPf": (158, 0, 0),
    "_ZN7posegen20field_variant_kernelILi64ELb1EEEvPKfS2_iS2_iiNS_6LayoutEPK13__nv_bfloat16S2_iiiPf": (160, 0, 0),
    "_ZN7posegen21field_bwd_sm90_kernelENS_7BwdMapsEiNS_6LayoutEPK13__nv_bfloat16PKfS6_NS_7RowBiasES6_NS_9WorkspaceE": (168, 0, 0),
}


# the eval kernel's modes, by the start of their mangled names
PARENT_EVAL = {
    "_ZN7posegen16eval_sm90_kernelILi0EEEv": (168, 0, 0),
    "_ZN7posegen16eval_sm90_kernelILi1EEEv": (168, 0, 0),
    "_ZN7posegen16eval_sm90_kernelILi2EEEv": (168, 0, 0),
    "_ZN7posegen16eval_sm90_kernelILi3EEEv": (168, 0, 0),
}


def main() -> int:
    build.build()
    got = build.ptxas_report()
    if not got:
        print("ptxas_vs_parent: no ptxas report beside the library", file=sys.stderr)
        return 1
    differ = 0
    pairs = [(name, got.get(name), want) for name, want in PARENT.items()]
    for prefix, want in PARENT_EVAL.items():
        found = [k for k in got if k.startswith(prefix)]
        pairs.append((prefix, got[found[0]] if len(found) == 1 else None, want))
    for name, have, want in pairs:
        differ += have != want
        print(f"{'same' if have == want else 'DIFFERS'}: {have} (parent {want}) {name}")
    print(f"ptxas_vs_parent: {len(pairs) - differ} of {len(pairs)} kernels keep the parent's "
          "(registers, spill stores, spill loads)")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
