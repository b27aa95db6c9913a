"""The yardstick's plain side: the corpus generator and the exact search.

Imports nothing of the program under test.
"""
