"""The plain reference the comparison holds the program against. It imports
nothing of the program under test."""
