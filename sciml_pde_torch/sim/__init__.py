"""Simulators and data generators: diffusion-reaction (``diff_react.py``,
``gen_diff_react.py``, ``downsample_dr.py``), 2D incompressible
Navier-Stokes (``ns_incomp_2d.py``, ``grf.py``, ``gen_ns_incomp.py``), the
3D buoyant plume (``ns_plume_3d.py``), 1D Burgers (``burgers_1d.py``), 2D
Darcy flow (``darcy_2d.py``), 2D electro- and magnetostatic BVPs
(``bvp_2d.py``), compressible flow around an airfoil (``airfoil_2d.py``),
spectral vorticity (``vorticity.py``, ``velocity2vorticity.py``), dataset
previews (``preview.py``) and Lie-point-symmetry augmentation of NS windows
(``lie.py``)."""
