"""Convert 3dcons PSSM files to the deeprank PSSM format
(reference `tools/pssm_3dcons_to_deeprank.py:5-33`).

3dcons data rows have 44 whitespace tokens; the converter keeps the
residue id/name, the 20 substitution scores (fixed columns 11:90 of
the raw line) and the trailing information content, writing
`pdbresi pdbresn seqresi seqresn <20 scores> IC` rows into
`<name>.deeprank.pssm`.

The port's own copy of ``deeprank_gnn_tpu/tools/pssm_3dcons.py``.
"""

from __future__ import annotations

import glob
import os
import sys

HEADER = (
    "pdbresi pdbresn seqresi seqresn    A    R    N    D    C    Q    E"
    "    G    H    I    L    K    M    F    P    S    T    W    Y    V   IC\n"
)


def pssm_3dcons_to_deeprank(pssm_file: str) -> str:
    with open(pssm_file, "r") as f:
        lines = f.readlines()

    outname = pssm_file.rsplit(".", 1)[0] + ".deeprank.pssm"
    with open(outname, "w") as out:
        out.write(HEADER)
        for line in lines:
            if len(line.split()) != 44:
                continue
            resid = line[0:6].strip()
            resn = line[6]
            scores = line[11:90]
            ic = line.split()[-1]
            out.write(
                f"{resid:>5} {resn:1} {resid:>5} {resn:1}    {scores} {ic}\n"
            )
    return outname


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(
            "Converts 3dcons pssm files into deeprank pssm format.\n"
            "Usage: python -m deeprank_gnn_tpu_torch.tools.pssm_3dcons <path>"
        )
    else:
        path = sys.argv[1]
        files = (
            glob.glob(os.path.join(path, "*.pssm"))
            if os.path.isdir(path)
            else [path]
        )
        for f in files:
            pssm_3dcons_to_deeprank(f)
