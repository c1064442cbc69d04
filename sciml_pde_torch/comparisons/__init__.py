"""The comparison models' trainers and evaluations (port of
``sciml_pde_tpu/comparisons``): OFormer and the Hyena hybrid on 2D
diffusion-reaction (``oformer_dr2d``), OFormer on PDEBench-format Burgers
and Darcy (``oformer_generic``), the irregular point-set BVP and airfoil
operators (``pointset_bvp``) and the velocity-HDF5 to magnitude-frame
converter (``make_npy``)."""
