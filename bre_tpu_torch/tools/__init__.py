"""The command-line tools of pbrt's src/tools/, over the port: imgtool (with
makesky on the Hosek-Wilkie and Preetham sky models), obj2pbrt, cyhair2pbrt
and bsdftest.  Each runs as ``python -m bre_tpu_torch.tools.<name>``."""
