"""Command-line mirrors of the reference's Test_Regression_x,
Test_Statistics_x, Test_AddMul_x and Test_General_x, over the port (see
test_regression.py)."""
