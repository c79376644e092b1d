"""FASTA reader with reference-identical record semantics.

Mirrors the reference line parser (ref: pastar/read_fasta.cpp:21-34):
  * a line starting with '>' or an empty line terminates the current record;
  * consecutive non-empty, non-'>' lines are concatenated into one sequence;
  * sequence bodies are NOT sanitised — dashes and arbitrary characters are
    kept verbatim (the bundled test.fasta contains a literal "BBBB---").
"""
from __future__ import annotations

import io
import os
from typing import List


def read_fasta_text(text: str) -> List[str]:
    """Parse FASTA-formatted text into the list of sequence strings."""
    seqs: List[str] = []
    lines = io.StringIO(text)
    eof = False
    while not eof:
        seq_parts: List[str] = []
        while True:
            buf = lines.readline()
            if buf == "":
                eof = True
                break
            buf = buf.rstrip("\n").rstrip("\r")
            if len(buf) <= 0 or buf[0] == ">":
                break
            seq_parts.append(buf)
        seq = "".join(seq_parts)
        if seq:
            seqs.append(seq)
    return seqs


def read_fasta_file(path: str | os.PathLike) -> List[str]:
    """Read a FASTA file (ref: pastar/read_fasta.cpp:41-56)."""
    with open(path, "r") as f:
        return read_fasta_text(f.read())
