"""Simulators and data generators: diffusion-reaction (``diff_react.py``,
``gen_diff_react.py``, ``downsample_dr.py``), 2D incompressible
Navier-Stokes (``ns_incomp_2d.py``, ``grf.py``, ``gen_ns_incomp.py``),
spectral vorticity (``vorticity.py``, ``velocity2vorticity.py``), dataset
previews (``preview.py``) and Lie-point-symmetry augmentation of NS windows
(``lie.py``)."""
