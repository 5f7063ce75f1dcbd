"""IMU preintegration and windowing."""
