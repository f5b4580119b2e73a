"""The benchmark's plain reference: BFV keys, encryption and decryption,
PASTA-3 and the integer models, in plain PyTorch and NumPy.  Imports
nothing of the program under test."""
