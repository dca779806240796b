"""Multi-device serving and training of the port: sharding rules, the SPMD
routing context, the collectives and their autograd forms, and the GPipe
pipeline (port of ``repro/distributed/``; the int8 compressed all-reduce is
``repro_torch.optim.compression``)."""
