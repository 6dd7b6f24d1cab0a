"""Sensor data input: ROS1 bag replay."""
