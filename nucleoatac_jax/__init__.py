"""nucleoatac-jax: a nucleosome-calling engine on an accelerator.

A from-scratch rebuild of the capabilities of GreenleafLab/NucleoATAC
(Schep et al., Genome Research 2015) in JAX: batched device programs
over fixed-shape peak-window tensors, a C++ BAM/BGZF ingest layer, and
data parallelism over a device mesh.

Numerical contract: DESIGN.md. Reference structure: SURVEY.md.
"""

__version__ = "0.1.0"
