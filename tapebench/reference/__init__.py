"""The plain reference of the benchmark's check: frozen copies of the
port's plain PyTorch decode of NRZI and PE captures (decode.py and the
modules it reads), which import nothing of the program."""
