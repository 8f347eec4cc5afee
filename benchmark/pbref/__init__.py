"""A frozen copy of the plain PyTorch render path of ``bre_tpu_torch`` at
commit b8e63ac, the benchmark's reference (see ``benchmark/README.md``).

The modules are the port's, byte for byte, but for this file and the
kernel wrappers of ``ops/gather.py`` and ``ops/gather_bwd.py``, which are
bound to their plain versions, so nothing here launches a kernel or
imports the program.
"""
