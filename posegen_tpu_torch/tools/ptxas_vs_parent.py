"""Compare the build's ptxas report with the commit before the Hopper
redesign of the eval kernels (kernels 1 and 2, csrc/field.cu).

    python -m posegen_tpu_torch.tools.ptxas_vs_parent

Builds the kernels (or loads the cached build) on a machine with nvcc and
prints, for every kernel that redesign left alone (the stash kernel,
kernel 4's passes (a), (b) and its reduce, pass (c) and the small
reductions, the variants), its registers and spill bytes beside the ones
that commit's build reported for sm_90a. Exits 1 if one differs. A record
of that change: a later edit of one of these kernels, or another nvcc,
changes the report with no fault in the port.
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
    "_ZN7posegen18field_stash_kernelEPKfS1_iiS1_iiNS_6LayoutEPK13__nv_bfloat16S1_S1_NS_7RowBiasEPfPS3_S8_": (128, 0, 0),
    "_ZN7posegen18pose_reduce_kernelEPKfiiiPfi": (30, 0, 0),
    "_ZN7posegen19wgrad_reduce_kernelENS_9WgradJobsE": (31, 0, 0),
    "_ZN7posegen20field_variant_kernelILi128ELb0EEEvPKfS2_iS2_iiNS_6LayoutEPK13__nv_bfloat16S2_iiiPf": (253, 0, 0),
    "_ZN7posegen20field_variant_kernelILi128ELb1EEEvPKfS2_iS2_iiNS_6LayoutEPK13__nv_bfloat16S2_iiiPf": (254, 0, 0),
    "_ZN7posegen20field_variant_kernelILi32ELb0EEEvPKfS2_iS2_iiNS_6LayoutEPK13__nv_bfloat16S2_iiiPf": (110, 0, 0),
    "_ZN7posegen20field_variant_kernelILi32ELb1EEEvPKfS2_iS2_iiNS_6LayoutEPK13__nv_bfloat16S2_iiiPf": (110, 0, 0),
    "_ZN7posegen20field_variant_kernelILi64ELb0EEEvPKfS2_iS2_iiNS_6LayoutEPK13__nv_bfloat16S2_iiiPf": (158, 0, 0),
    "_ZN7posegen20field_variant_kernelILi64ELb1EEEvPKfS2_iS2_iiNS_6LayoutEPK13__nv_bfloat16S2_iiiPf": (160, 0, 0),
    "_ZN7posegen21field_bwd_sm90_kernelENS_7BwdMapsEiNS_6LayoutEPK13__nv_bfloat16PKfS6_NS_7RowBiasES6_NS_9WorkspaceE": (168, 0, 0),
    "_ZN7posegen22field_bwd_input_kernelEiiPKfS1_S1_iiiNS_6LayoutEPK13__nv_bfloat16NS_9WorkspaceEPfS7_S7_": (102, 0, 0),
}


def main() -> int:
    build.build()
    got = build.ptxas_report()
    if not got:
        print("ptxas_vs_parent: no ptxas report beside the library", file=sys.stderr)
        return 1
    differ = 0
    for name, want in PARENT.items():
        have = got.get(name)
        differ += have != want
        print(f"{'same' if have == want else 'DIFFERS'}: {have} (parent {want}) {name}")
    print(f"ptxas_vs_parent: {len(PARENT) - differ} of {len(PARENT)} kernels keep the parent's "
          "(registers, spill stores, spill loads)")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
