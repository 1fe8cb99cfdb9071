"""The decentralized trainer (Prox-LEAD as the outer optimizer of NN
training) and its wire exchange."""
