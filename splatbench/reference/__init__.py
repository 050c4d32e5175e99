"""The plain reference the output check holds the program to."""
