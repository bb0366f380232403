"""Plain references of the own-format encoder; nothing here imports the program."""
