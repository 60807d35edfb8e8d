"""Drivers: the code that runs one unit of a traffic mix through the program."""
