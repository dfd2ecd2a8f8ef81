"""Multi-stream and multi-device interpolation: `batched.batched_step` (B
streams in lockstep on one device), `mesh.make_multichip_step` (a dp x sp
mesh of ranks on torch.distributed) and `launch.run_ranks` (starts the ranks).
"""
