"""Command-line mirrors of the reference's Test_Regression_x and
Test_Statistics_x, over the port (see test_regression.py)."""
