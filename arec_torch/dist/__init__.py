"""Port of `arec.dist`: the process group, the ("data", "model") device
mesh, the sharding rules and the rank ↔ whole-array bridge."""
