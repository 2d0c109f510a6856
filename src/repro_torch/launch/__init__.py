from repro_torch.launch.mesh import make_production_mesh, make_host_mesh
