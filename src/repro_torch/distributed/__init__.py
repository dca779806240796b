"""Multi-device serving of the port: sharding rules, the SPMD routing
context and the collectives (port of ``repro/distributed/``; the mesh
trainer's pipeline and compressed all-reduce are not ported yet)."""
