from nucleoatac_jax.io.bam import BamFragments, scan_bam
from nucleoatac_jax.io.fasta import FastaFile

__all__ = ["BamFragments", "scan_bam", "FastaFile"]
