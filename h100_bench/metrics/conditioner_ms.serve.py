"""Device ms per DDIM step of the kernels launched inside the port's
`md.mesh_voxel` span (the mesh conditioner: MeshVoxelNet or FineMeshVoxelNet)."""

from h100_bench import program_spans


def read(s):
    return program_spans.device_ms(s, "md.mesh_voxel") if s["kind"] == "serve" else None
