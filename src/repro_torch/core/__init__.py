# Core algorithm pieces: topology, compression, prox, COMM, oracles,
# Prox-LEAD, and the draw source that feeds them random numbers.
