"""Distribution of the port: so far the low-rank gradient compression
(PowerSGD) that the training step takes as its ``grad_transform``.  The
sharding rules wait for the port's device mesh."""
