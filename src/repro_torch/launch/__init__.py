# The port's command-line programs: sweep (grids), simulate (netsim
# scenarios), train (the decentralized NN trainer).  Each runs on the card
# unless given --device cpu.
