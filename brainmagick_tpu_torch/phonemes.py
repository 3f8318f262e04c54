"""Phoneme id inventory: a copy of ``brainmagick_tpu/phonemes.py`` (43
SAMPA phonemes, ids 0..42; features shift them by one, 0 being
silence)."""

ph_dict = {
    "d": 0, "@": 1, "b": 2, "A": 3, "n": 4, "s": 5, "i": 6, "E": 7, "r": 8,
    "x": 9, "p": 10, "o:": 11, "y": 12, "l": 13, "E:": 14, "Ei": 15, "N": 16,
    "e:": 17, "O": 18, "m": 19, "t": 20, "I": 21, "G": 22, "w": 23, "k": 24,
    "h": 25, "v": 26, "j": 27, "a:": 28, "u": 29, "z": 30, "Y": 31, "f": 32,
    "9y": 33, "S": 34, "ui": 35, "Au": 36, "Z": 37, "9:": 38, "2:": 39,
    "g": 40, "J": 41, "O:": 42,
}
