"""Compare the build's ptxas report with the commit before the A/B harness's
variant kernel became instantiations of the eval kernel (csrc/field_eval.cuh
eval_sm90_kernel<MODE, VAR>, csrc/field_variants.cu).

    python -m posegen_tpu_torch.tools.ptxas_vs_parent [--parent DIR]

Builds the kernels (or loads the cached build) on a machine with nvcc and
prints, for the eval kernel's seven production modes (VAR 0, found by the
start of their mangled names), every kernel of the backward (kernel 4's
passes (a), (b), (c) and their reductions) and the view-ladder kernel, its
registers and spill bytes beside the ones that commit's build reported
for sm_90a; and for each variant instantiation, the ones this change's
build reported. With --parent, a checkout of that commit (for example
`git archive <commit> | tar -x -C build/parent`), it also builds the
kernels there and compares the SASS of those production kernels
(cuobjdump -sass, without addresses and encodings) with this build's.
Exits 1 if one differs. A record of that change: a later edit of one of
these kernels, or another nvcc, changes the report with no fault in the
port.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
from typing import Dict, List

from posegen_tpu_torch.kernels import build

# (registers, spill store bytes, spill load bytes) of the parent's build
PARENT = {
    "_ZN7posegen14ray_sum_kernelEPKfiiPf": (30, 0, 0),
    "_ZN7posegen16vbias_sum_kernelEPKfiPf": (30, 0, 0),
    "_ZN7posegen17input_sm90_kernelENS_9InputMapsENS_6LayoutEi": (168, 0, 0),
    "_ZN7posegen17vbias_part_kernelEPKfiiiPf": (31, 0, 0),
    "_ZN7posegen17wgrad_sm90_kernelENS_9WgradJobsE": (154, 0, 0),
    "_ZN7posegen18bias_reduce_kernelEPKfiNS_6LayoutEPf": (32, 0, 0),
    "_ZN7posegen18input_chain_kernelEiiPKfS1_S1_iiiNS_6LayoutENS_9WorkspaceEPfS4_S4_": (64, 0, 0),
    "_ZN7posegen18pose_reduce_kernelEPKfiiiPfi": (30, 0, 0),
    "_ZN7posegen18view_ladder_kernelEPKfiS1_iiPf": (32, 0, 0),
    "_ZN7posegen19wgrad_reduce_kernelENS_9WgradJobsE": (31, 0, 0),
    "_ZN7posegen21field_bwd_sm90_kernelENS_7BwdMapsEiNS_6LayoutEPK13__nv_bfloat16PKfS6_NS_7RowBiasES6_NS_9WorkspaceE": (168, 0, 0),
}

# eval_sm90_kernel<MODE, VAR>, by the start of the mangled name: the seven
# production modes at VAR 0 (the parent's eval_sm90_kernel<MODE>), then the
# variants this change added (VAR: bf16enc 1, pipe2 17, mxenc 2, the encode
# probe 4, the gate probe 8), whose values are this change's build's
EVAL = {
    **{f"_ZN7posegen16eval_sm90_kernelILi{mode}ELi0EEEv": (168, 0, 0) for mode in range(7)},
    **{f"_ZN7posegen16eval_sm90_kernelILi4ELi{var}EEEv": (168, 0, 0) for var in (1, 17, 2, 4, 8)},
    "_ZN7posegen16eval_sm90_kernelILi5ELi2EEEv": (168, 0, 0),
}


def sass(lib: str) -> Dict[str, List[str]]:
    """cuobjdump -sass of a library -> {mangled kernel: its instructions},
    addresses and encodings stripped."""
    cob = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([cob, "-sass", lib], capture_output=True, text=True, check=True).stdout
    kernels = {}
    for sec in out.split("Function : ")[1:]:
        name, body = sec.split("\n", 1)
        body = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", body)
        kernels[name.strip()] = [line.strip() for line in body.splitlines()
                                 if line.strip().endswith(";")]
    return kernels


def sass_vs_parent(parent: str) -> int:
    """Build the kernels in the parent's checkout; print whether each
    production kernel's SASS equals this build's -> how many differ."""
    code = "from posegen_tpu_torch.kernels import build; print(build.build())"
    parent_lib = subprocess.run([sys.executable, "-c", code], cwd=parent, capture_output=True,
                                text=True, check=True).stdout.strip().splitlines()[-1]
    mine, theirs = sass(str(build.library_path())), sass(parent_lib)
    differ = 0
    for name in PARENT:
        differ += _same_sass(name, theirs.get(name), mine.get(name))
    for prefix in list(EVAL)[:7]:  # VAR 0: the parent's eval_sm90_kernel<MODE>
        old = prefix.replace("ELi0EEEv", "EEEv")
        differ += _same_sass(prefix, _by_prefix(theirs, old), _by_prefix(mine, prefix))
    return differ


def _by_prefix(kernels: Dict[str, List[str]], prefix: str):
    return next((v for k, v in kernels.items() if k.startswith(prefix)), None)


def _same_sass(name: str, theirs, mine) -> int:
    same = theirs is not None and theirs == mine
    print(f"SASS {'identical' if same else 'DIFFERS'}: {len(mine or [])} instructions "
          f"(parent {len(theirs or [])}) {name}")
    return int(not same)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of the parent commit: compare SASS too")
    args = ap.parse_args(argv)
    build.build()
    got = build.ptxas_report()
    if not got:
        print("ptxas_vs_parent: no ptxas report beside the library", file=sys.stderr)
        return 1
    differ = 0
    pairs = [(name, got.get(name), want) for name, want in PARENT.items()]
    for prefix, want in EVAL.items():
        found = [k for k in got if k.startswith(prefix)]
        pairs.append((prefix, got[found[0]] if len(found) == 1 else None, want))
    for name, have, want in pairs:
        differ += have != want
        print(f"{'same' if have == want else 'DIFFERS'}: {have} (recorded {want}) {name}")
    print(f"ptxas_vs_parent: {len(pairs) - differ} of {len(pairs)} kernels keep the recorded "
          "(registers, spill stores, spill loads)")
    if args.parent:
        n = sass_vs_parent(args.parent)
        print(f"ptxas_vs_parent: {len(PARENT) + 7 - n} of {len(PARENT) + 7} production kernels' "
              "SASS identical to the parent's")
        differ += n
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
